"""Plain DCN-R: the reference that both configurations of this folder are
judged against. Plain PyTorch, no code of the program, TF32 off.

    x0    = [user_emb ⊕ item_emb ⊕ cat_embs… ⊕ num_features]
    deep  = initial(x0), then per block: Linear→BN→ReLU→Dropout→Linear→BN,
            + identity, ReLU
    cross = x_{l+1} = x_l + x_l·(w_l·x_l) + b_l      (the "code" variant)
    logit = [deep ⊕ cross] @ W_f + b_f

BatchNorm normalizes by the batch's biased variance in training and by its
running statistics in eval. Dropout is inverted, ``keep = 1 − rate``
rounded to the model's dtype, its masks ``rand(shape) < keep`` drawn from a
``torch.Generator`` seeded with the training seed, one draw per block and
step, in block order. The loss is the mean binary cross-entropy on logits,
the optimizer AdamW (betas 0.9, 0.999, eps 1e-8, decoupled decay).

Precision is a :class:`Prec`: the dtype every tensor is held in, the
rounding of stored activations (the model's storage dtype), and the rounding
of the operands of every product (its compute dtype). A float32 model is
worked out in float64; a bfloat16 model in float32 with every cast of its
dtype rules rounded to bfloat16, as the configuration states them. The
lower precisions of the controls are TF32 operands (10 mantissa bits) and
fp8 (e4m3, scaled per tensor to its largest magnitude; gradients e5m2).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _tf32_bits(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits), to nearest even."""
    bits = t.float().contiguous().view(torch.int32)
    bias = ((bits >> 13) & 1) + 0xFFF
    return ((bits + bias) & ~0x1FFF).view(torch.float32).to(t.dtype)


def _fp8_bits(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    amax = t.detach().abs().max()
    s = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((t * s).float().to(dtype).float() / s).to(t.dtype)


class _TF32(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _tf32_bits(t)

    @staticmethod
    def backward(ctx, g):
        return _tf32_bits(g)


class _FP8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8_bits(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_bits(g, torch.float8_e5m2, 57344.0)


@dataclass(frozen=True)
class Prec:
    name: str
    dtype: torch.dtype  # every tensor's
    store: Callable  # rounding of a stored activation
    mm: Callable  # rounding of a product's operand


PRECS = {
    "float64": Prec("float64", torch.float64, _identity, _identity),
    "bfloat16": Prec("bfloat16", torch.float32, _bf16, _bf16),
    "tf32": Prec("tf32", torch.float32, _identity, _TF32.apply),
    "fp8": Prec("fp8", torch.float32, _FP8.apply, _FP8.apply),
}


def reference_prec(cfg: dict) -> Prec:
    """The reference's precision for a configuration's stated dtype."""
    dt = cfg["compute_dtype"]
    if dt != cfg["storage_dtype"]:
        raise ValueError("the reference takes one dtype for compute and storage")
    return PRECS["float64" if dt == "float32" else "bfloat16"]


def control_prec(cfg: dict) -> Prec:
    """The nearest precision below the stated one: TF32 operands for a
    float32 model with TF32 off, fp8 for a bfloat16 one."""
    return PRECS["tf32" if cfg["compute_dtype"] == "float32" else "fp8"]


def keep_of(cfg: dict) -> float:
    """1 − dropout, rounded to the model's dtype."""
    dt = torch.float32 if cfg["compute_dtype"] == "float32" else torch.bfloat16
    return float(torch.tensor(1.0 - cfg["dropout"], dtype=dt).item())


def x0_of(p: dict, users, items, cats, num, P: Prec) -> torch.Tensor:
    parts = [p["user_embedding"][users], p["item_embedding"][items]]
    parts += [p[f"cat_embeddings.{i}"][cats[:, i]] for i in range(cats.shape[1])]
    return P.store(torch.cat(parts + [num.to(P.dtype)], dim=1))


def _linear(x, p, name, P: Prec, store: bool = True):
    y = P.mm(x) @ P.mm(p[f"{name}.kernel"]) + p[f"{name}.bias"]
    return P.store(y) if store else y


def _bn(x, p, name, P: Prec, eps: float, stats=None):
    if stats is None:
        mean = x.mean(dim=0)
        var = (x - mean).square().mean(dim=0)
    else:
        mean, var = stats[f"{name}.mean"], stats[f"{name}.var"]
    return P.store((x - mean) * torch.rsqrt(var + eps) * p[f"{name}.scale"] + p[f"{name}.bias"])


def tower(p: dict, x0: torch.Tensor, cfg: dict, P: Prec, masks=None, stats=None) -> torch.Tensor:
    """x0 → logits. ``masks``: one bool ``[B, H]`` dropout mask per block
    (training, batch statistics); else ``stats`` holds the running
    statistics (eval)."""
    eps, keep = cfg.get("bn_eps", 1e-5), keep_of(cfg)
    deep = _linear(x0, p, "initial_deep", P)
    for r in range(cfg["n_res_blocks"]):
        b = f"res_blocks.{r}"
        h = torch.relu(_bn(_linear(deep, p, f"{b}.layer1", P), p, f"{b}.bn1", P, eps, stats))
        if masks is not None:
            h = torch.where(masks[r], P.store(h / keep), torch.zeros((), dtype=h.dtype, device=h.device))
        h = _bn(_linear(h, p, f"{b}.layer2", P), p, f"{b}.bn2", P, eps, stats)
        deep = torch.relu(P.store(h + deep))
    x, w, bias = x0, P.store(p["cross.w"]), P.store(p["cross.b"])
    for l in range(cfg["n_cross_layers"]):
        gate = P.store((P.mm(x) * P.mm(w[l])).sum(dim=1, keepdim=True))
        x = P.store(P.store(x + P.store(x * gate)) + bias[l])
    z = torch.cat([deep, x], dim=1)
    return (P.mm(z) @ P.mm(p["final.kernel"]) + p["final.bias"])[:, 0]


def bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(logits, min=0) - logits * y + torch.log1p(torch.exp(-logits.abs()))).mean()


def train_steps(p0: dict, steps, cfg: dict, train: dict, P: Prec, half_batch: bool = False,
                keep: tuple = ()) -> dict:
    """AdamW steps from the parameters ``p0``, one for each ``(batch,
    masks)`` of ``steps`` → {"losses" (each step's), "grad_norms" (each
    leaf's norm at the first step), "params" ({t: the parameters after step
    t} for each t of ``keep``)}. ``half_batch`` plants the fault of a step
    that leaves half of the batch out and takes the mean over the rest."""
    p = {k: v.detach().to(P.dtype).clone() for k, v in p0.items() if not k.endswith((".mean", ".var"))}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    lr, wd, (b1, b2), eps = train["lr"], train["weight_decay"], (0.9, 0.999), 1e-8
    losses, grad_norms, kept = [], None, {}
    for t, (batch, mask) in enumerate(steps, start=1):
        leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        x0 = x0_of(leaves, batch["user"], batch["item"], batch["cat"], batch["num"], P)
        logits = tower(leaves, x0, cfg, P, masks=mask)
        y = batch["y"].to(P.dtype)
        if half_batch:
            n = y.shape[0] // 2
            logits, y = logits[:n], y[:n]
        loss = bce(logits, y)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        losses.append(loss.detach())
        g = dict(zip(leaves, grads))
        if grad_norms is None:
            grad_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in g.items()}
        with torch.no_grad():
            for k in p:
                p[k].mul_(1 - lr * wd)
                m[k].lerp_(g[k], 1 - b1)
                v2[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                denom = (v2[k].sqrt() / (1 - b2 ** t) ** 0.5).add_(eps)
                p[k].addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
        if t in keep:
            kept[t] = {k: v.clone() for k, v in p.items()}
    return {"losses": [float(x) for x in torch.stack(losses).tolist()], "grad_norms": grad_norms, "params": kept}
