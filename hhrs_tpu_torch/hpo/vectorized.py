"""Vectorized HPO: train K same-architecture trials as one program
(counterpart of ``hhrs_tpu/hpo/vectorized.py``).

The JAX package ``jax.vmap``s one trial's step over K lanes. Here the K
lanes are written out: :class:`LaneDCNR` holds K copies of a ``DCNR``'s
parameters and BatchNorm state stacked ``[K, …]`` in one flat ``[K, P]``
buffer (each tensor a view of it), and its forward is the model's with a
leading lane axis: the gathers take one index vector for every lane, the
linears are batched products (``torch.bmm``), BatchNorm takes each lane's
statistics over that lane's rows, and the cross stack is ONE launch of the
trial-axis kernels forward and one backward (``ops/cross.py::
cross_stack_trials``) for all K lanes. A step is one forward, one backward
and one hand-written Adam-family update of the flat buffer with per-lane
``lr`` and ``weight_decay`` (``torch.optim`` takes one learning rate).

What is per lane and what is shared:

* per lane: ``lr``, ``weight_decay``, ``dropout`` (each a ``[K]`` tensor),
  the parameters, BatchNorm state, Adam moments and step counts;
* per group (must agree): ``ARCH_KEYS``, the optimizer family included
  (adam's L2-coupled decay and adamw's decoupled decay are different
  updates);
* on the host, per lane, as the sequential trainer runs them: plateau LR,
  early stopping, pruning, best-state bookkeeping (the best state stays on
  the device, selected per lane).

Parity: lane k reproduces the port's sequential ``train_dcn`` for trial k
with dropout on. Every lane starts from the initialization of seed
``tcfg.seed`` (the sequential trainer's); the shuffle is
``np.random.default_rng(tcfg.seed)``; each dropout site draws its uniform
tensor ONCE per step from the trainer's generator, in the sequential
trainer's order (the JAX package closes every lane over one step key the
same way), and lane k keeps ``u < keep_k`` and scales by its own
``keep_k`` rounded to the dtype as ``ops/nn.py::dropout`` does, so lane
k's masks are the sequential trial's; the update takes the operations of
``torch.optim.AdamW`` / ``Adam(foreach=True)`` in their order, with the
bias corrections in float64 on the device. The products and reductions
add in other orders than the single-trial model's, so lanes meet the
sequential runs at the trajectory bars, not bit for bit.

Lanes that early-stop or prune keep riding the program, ignored on the
host, unless ``refill_fn`` reclaims them for new trials of the same
architecture (fresh init, fresh moments, the lane's own epoch clock).

``shard_lanes`` splits the trial axis over the ranks of the initialized
``torch.distributed`` world (JAX's 1-D ``("trial",)`` mesh over every
device): rank r holds lanes ``[r·K/n, (r+1)·K/n)`` and the whole dataset,
draws the same uniform tensors and shuffle as every other rank (so a
lane's masks are the unsharded group's), and launches the cross kernels
under the K-lane group's plans (so a lane's dw and db are summed in the
unsharded group's order); every per-lane sum is one whose order does not
depend on K (:class:`LaneHead`, :func:`lane_bce`, the train loss), so a
rank's lanes are the unsharded group's bit for bit. The host bookkeeping
of all K lanes runs on every
rank: one ``all_gather`` an epoch of the lanes' val and train losses, and
one ``all_gather_object`` of the finished trials' weights and metrics
wherever lanes finish, so every rank takes the same decisions, asks the
same refills and returns the same results.
"""

from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.data.preprocess import DatasetSplits
from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.models.convert import dcnr_from_jax, jax_from_dcnr
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops.cross import cross_stack_trials
from hhrs_tpu_torch.parallel.mesh import all_gather
from hhrs_tpu_torch.retrieval.similarity import require_full_f32_matmul
from hhrs_tpu_torch.train.metrics import auc_score, bce_with_logits, recall_at_k, rmse_of_probs
from hhrs_tpu_torch.train.optimizers import PlateauScheduler
from hhrs_tpu_torch.train.trainer import RNG_IMPLS, eval_logits, split_tensors

log = logging.getLogger(__name__)

# Hyperparams that must agree across a vectorized group (shape / program
# structure); everything else in the reference space is either a per-lane
# scalar (dropout, lr, weight_decay) or host-side (plateau knobs).
ARCH_KEYS = ("emb_dim", "hidden_dim", "n_cross_layers", "n_res_blocks",
             "batch_size", "optimizer")
VMAPPED_KEYS = ("dropout", "lr", "weight_decay")

_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}  # None: f32, no cast


def arch_key(params: dict) -> tuple:
    """The grouping key of one trial's sampled hyperparams."""
    return tuple(params[k] for k in ARCH_KEYS)


def group_trials(param_dicts: list[dict]) -> dict[tuple, list[int]]:
    """Indices of ``param_dicts`` grouped by architecture key (insertion
    order preserved so trial numbering stays monotonic per group)."""
    groups: dict[tuple, list[int]] = {}
    for i, p in enumerate(param_dicts):
        groups.setdefault(arch_key(p), []).append(i)
    return groups


@dataclass
class VTrialResult:
    """Per-trial outcome of a vectorized group — the subset of
    train_dcn's TrainResult the HPO driver consumes, plus the group rate."""

    params: dict
    bn_state: dict
    history: list = field(default_factory=list)
    best_val_loss: float = float("inf")
    best_epoch: int = -1
    final_metrics: dict = field(default_factory=dict)
    pruned: bool = False
    # per-trial data rate (B·steps / median epoch seconds); the group
    # processes group_examples_per_s = K × this in the same wall-clock.
    examples_per_s: float = 0.0
    group_examples_per_s: float = 0.0


def _flat(tensors: dict, K: int, requires_grad: bool) -> tuple:
    """K copies of ``tensors`` in one ``[K, P]`` float32 buffer →
    ``(buffer, {name: [K, *shape] view})``; with ``requires_grad`` each view
    is an autograd leaf of its own over the buffer's memory."""
    numel = sum(t.numel() for t in tensors.values())
    dev = next(iter(tensors.values())).device
    flat = torch.empty((K, numel), dtype=torch.float32, device=dev)
    views, at = {}, 0
    for name, t in tensors.items():
        view = flat[:, at:at + t.numel()]
        view.copy_(t.detach().reshape(1, -1).float())
        view = view.view(K, *t.shape)
        views[name] = view.detach().requires_grad_() if requires_grad else view
        at += t.numel()
    return flat, views


class LaneDCNR:
    """K copies of a ``DCNR`` (its ``named_parameters`` and
    ``named_buffers``, stacked ``[K, …]``), run together. ``flat`` holds the
    parameters, ``flat_state`` the BatchNorm running statistics; ``params``
    and ``state`` are their views by the model's names. ``init`` and
    ``init_state`` keep the one lane they started from, for a refill.
    ``plan_lanes``: the cross kernels launch under the plans of a group of
    that many lanes (None: K)."""

    def __init__(self, model: DCNR, dims: ModelDims, K: int, plan_lanes: int | None = None):
        cfg = model.cfg
        self.cfg, self.dims, self.K, self.plan_lanes = cfg, dims, K, plan_lanes
        self.has_deep, self.has_cross = model.has_deep, model.has_cross
        self.n_cat = len(model.cat_embeddings)
        self.n_blocks = len(model.res_blocks) if model.has_deep else 0
        self.flat, self.params = _flat(dict(model.named_parameters()), K, requires_grad=True)
        self.flat_state, self.state = _flat(dict(model.named_buffers()), K, requires_grad=False)
        self.init, self.init_state = self.flat[0].clone(), self.flat_state[0].clone()
        self.leaves = list(self.params.values())  # in the order of flat's columns

    def reset_lane(self, k: int) -> None:
        """Lane k back to the initial parameters and BatchNorm state."""
        with torch.no_grad():
            self.flat[k].copy_(self.init)
            self.flat_state[k].copy_(self.init_state)

    def lane_model(self, k: int, flat: torch.Tensor, flat_state: torch.Tensor) -> DCNR:
        """A single ``DCNR`` (eval mode, the lanes' device) holding lane k of
        ``flat`` / ``flat_state`` (buffers laid out as ``self.flat`` and
        ``self.flat_state``)."""
        state, at = {}, 0
        for name, t in self.params.items():
            n = t[0].numel()
            state[name] = flat[k, at:at + n].view(t.shape[1:]).clone()
            at += n
        at = 0
        for name, t in self.state.items():
            n = t[0].numel()
            state[name] = flat_state[k, at:at + n].view(t.shape[1:]).clone()
            at += n
        with torch.device("meta"):
            model = DCNR(self.dims, self.cfg)
        model.load_state_dict(state, strict=True, assign=True)
        return model.eval()

    # ---- the forward pass, lane by lane (DCNR.forward with a lane axis) ----

    def forward(self, user, item, cat, num, train: bool, keep: tuple | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """``[B]`` indices and features, shared by every lane → f32 logits
        ``[K, B]``. In train mode BatchNorm uses and updates each lane's
        batch statistics, and dropout applies ``keep = (keep_f32 [K, 1, 1],
        keep_in_dtype [K, 1, 1])`` (None: every lane's rate is 0) to one
        uniform draw per site from ``generator``."""
        P, K = self.params, self.K
        compute, storage = _DTYPES[self.cfg.compute_dtype], _DTYPES[self.cfg.storage_dtype]
        cats = [P[f"cat_embeddings.{i}"][:, cat[:, i]] for i in range(self.n_cat)]
        x0 = torch.cat([P["user_embedding"][:, user], P["item_embedding"][:, item], *cats,
                        num.expand(K, *num.shape)], dim=2)
        if storage is not None:
            x0 = x0.to(storage)
        towers = []
        if self.has_deep:
            deep = self._linear("initial_deep", x0, compute, storage)
            for i in range(self.n_blocks):
                name = f"res_blocks.{i}"
                if self.cfg.arch == "dcn_mlp":
                    h = torch.relu(self._linear(f"{name}.layer", deep, compute, storage))
                    deep = self._dropout(h, keep, generator) if train else h
                    continue
                h = torch.relu(self._bn(f"{name}.bn1", self._linear(f"{name}.layer1", deep, compute, storage),
                                        train))
                if train:
                    h = self._dropout(h, keep, generator)
                h = self._bn(f"{name}.bn2", self._linear(f"{name}.layer2", h, compute, storage), train)
                deep = torch.relu(h + deep)
            towers.append(deep)
        if self.has_cross:
            w, b = P["cross.w"], P["cross.b"]
            x = x0
            if compute is not None:
                x, w, b = x0.to(compute), w.to(compute), b.to(compute)
            towers.append(cross_stack_trials(w.contiguous(), b.contiguous(), x.contiguous(),
                                             self.cfg.cross_variant, self.plan_lanes))
        return self._linear("final", torch.cat(towers, dim=2), compute, None)[:, :, 0]

    def _linear(self, name, x, compute, out_dtype):
        """``ops/nn.py::Linear`` per lane: a batched product of the operands
        in ``compute`` dtype with f32 sums, the bias added in f32."""
        k = self.params[f"{name}.kernel"]
        if compute is not None:
            x, k = x.to(compute), k.to(compute)
        if k.shape[2] == 1:  # the head
            return LaneHead.apply(x.float(), k.float(), self.params[f"{name}.bias"])
        y = torch.bmm(x.float(), k.float()) + self.params[f"{name}.bias"][:, None, :]
        return y if out_dtype is None else y.to(out_dtype)

    def _bn(self, name, x, train: bool):
        """``ops/nn.py::BatchNorm`` per lane, in f32."""
        scale, bias = self.params[f"{name}.scale"][:, None], self.params[f"{name}.bias"][:, None]
        run_mean, run_var = self.state[f"{name}.mean"], self.state[f"{name}.var"]
        eps, m = self.cfg.bn_eps, self.cfg.bn_momentum
        xf = x.float()
        if not train:
            return ((xf - run_mean[:, None]) * torch.rsqrt(run_var[:, None] + eps) * scale + bias).to(x.dtype)
        n = x.shape[1]
        if n <= 1:
            raise ValueError("BatchNorm training needs >1 example per batch (torch BatchNorm1d parity)")
        mean = xf.mean(dim=1)
        var_biased = (xf - mean[:, None]).square().mean(dim=1)
        with torch.no_grad():
            run_mean.copy_((1 - m) * run_mean + m * mean)
            run_var.copy_((1 - m) * run_var + m * (var_biased * (n / max(n - 1, 1))))
        return ((xf - mean[:, None]) * torch.rsqrt(var_biased + eps)[:, None] * scale + bias).to(x.dtype)

    @staticmethod
    def _dropout(x, keep, generator):
        """``ops/nn.py::dropout`` per lane on one shared uniform draw."""
        if keep is None:
            return x
        u = torch.rand(x.shape[1:], generator=generator, device=x.device)
        return torch.where(u < keep[0], x / keep[1], torch.zeros((), dtype=x.dtype, device=x.device))


class LaneHead(torch.autograd.Function):
    """Every lane's one-output layer, ``x [K, B, F] @ k [K, F, 1] + b [K, 1]``
    in f32 → ``[K, B, 1]``. The forward is the batched product; the backward
    sums each lane's kernel and bias gradients over its rows as one
    reduction of ``[K, B, F + 1]``, as every other layer's bias gradient is
    summed. The batched product's own backward (a ``[K, F, B] @ [K, B, 1]``
    product, and a reduction over B of ``K`` outputs for the bias) takes a
    kernel chosen by K on a card, so a lane's gradient would depend on how
    many lanes run beside it; this one does not (a rank's lanes of a
    sharded group are the whole group's)."""

    @staticmethod
    def forward(ctx, x, k, b):
        ctx.save_for_backward(x, k)
        return torch.bmm(x, k) + b[:, None, :]

    @staticmethod
    def backward(ctx, dy):
        x, k = ctx.saved_tensors
        g = (torch.cat([x, torch.ones_like(x[:, :, :1])], dim=2) * dy).sum(dim=1)  # [K, F + 1]
        return dy * k.transpose(1, 2), g[:, :-1, None], g[:, -1:]


def lane_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``train/metrics.py::bce_with_logits`` of each lane: ``[K, B]`` logits,
    ``[B]`` labels → ``[K]``. Each lane's mean is a reduction of its own row:
    a card's reduction over ``[K, B]`` splits the rows by K, so a lane's loss
    would depend on how many lanes run beside it."""
    per_ex = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return torch.stack([row.mean() for row in per_ex])


@torch.no_grad()
def lane_eval_logits(lane: LaneDCNR, data: dict, eval_batch: int) -> torch.Tensor:
    """Eval-mode logits of every lane on a whole split, in chunks of
    ``eval_batch`` rows → ``[K, n]`` (one trial-axis forward launch a chunk)."""
    n = data["y"].shape[0]
    chunks = [lane.forward(data["user"][i:i + eval_batch], data["item"][i:i + eval_batch],
                           data["cat"][i:i + eval_batch], data["num"][i:i + eval_batch], train=False)
              for i in range(0, n, eval_batch)]
    return torch.cat(chunks, dim=1) if chunks else torch.zeros((lane.K, 0), device=data["y"].device)


class LaneAdam:
    """Adam (``decoupled=False``: ``wd·p`` added to the gradient, as
    ``torch.optim.Adam(weight_decay=wd)``) or AdamW (``decoupled=True``:
    ``p·(1 − lr·wd)`` first, as ``torch.optim.AdamW``) over the flat ``[K,
    P]`` parameters, with a learning rate, a weight decay and a step count
    per lane. The operations are ``torch.optim``'s ``foreach`` ones in their
    order; the bias corrections, the step size and the decay factor are
    computed in float64 on the device (``torch.optim`` does them in Python
    floats) and rounded to float32 once, so no step waits on the host."""

    def __init__(self, flat: torch.Tensor, lrs, wds, decoupled: bool,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.decoupled, self.betas, self.eps = decoupled, betas, eps
        self.m, self.v = torch.zeros_like(flat), torch.zeros_like(flat)
        dev = flat.device
        self.t = torch.zeros(flat.shape[0], dtype=torch.float64, device=dev)
        self.lr = torch.as_tensor(np.asarray(lrs, np.float64), device=dev)
        self.wd = torch.as_tensor(np.asarray(wds, np.float64), device=dev)
        self._refresh()

    def _refresh(self) -> None:
        self.decay32 = (1 - self.lr * self.wd).float()[:, None]
        self.wd32 = self.wd.float()[:, None]

    def set_lanes(self, lrs, wds=None) -> None:
        """New per-lane learning rates (a plateau decay) and weight decays."""
        self.lr.copy_(torch.as_tensor(np.asarray(lrs, np.float64)))
        if wds is not None:
            self.wd.copy_(torch.as_tensor(np.asarray(wds, np.float64)))
        self._refresh()

    def reset_lane(self, k: int) -> None:
        self.m[k].zero_()
        self.v[k].zero_()
        self.t[k] = 0

    @torch.no_grad()
    def step(self, flat: torch.Tensor, grad: torch.Tensor) -> None:
        b1, b2 = self.betas
        self.t += 1
        bc1 = 1 - torch.pow(b1, self.t)
        bc2_sqrt = (1 - torch.pow(b2, self.t)).sqrt().float()[:, None]
        step_size = (self.lr / bc1 * -1).float()[:, None]
        if self.decoupled:
            flat.mul_(self.decay32)
        else:
            grad = grad + self.wd32 * flat
        self.m.lerp_(grad, 1 - b1)
        self.v.mul_(b2)
        self.v.addcmul_(grad, grad, value=1 - b2)
        denom = self.v.sqrt()
        denom.div_(bc2_sqrt)
        denom.add_(self.eps)
        flat.add_(self.m * step_size / denom)  # addcdiv's order: (value · m) / denom


def _make_trial_update(optimizer: str):
    """One K-lane training step of an ``adam`` or ``adamw`` group: forward
    in train mode, each lane's BCE, one backward (the lanes' losses summed:
    no lane's gradient reaches another's parameters), and the
    :class:`LaneAdam` update (built with ``decoupled=optimizer == "adamw"``).
    Returns ``update(lane, opt, batch, keep, generator) -> losses [K]``."""
    if optimizer not in ("adam", "adamw"):
        raise ValueError(f"unknown optimizer {optimizer!r}")

    def update(lane: LaneDCNR, opt: LaneAdam, batch: dict, keep, generator) -> torch.Tensor:
        logits = lane.forward(batch["user"], batch["item"], batch["cat"], batch["num"], train=True,
                              keep=keep, generator=generator)
        losses = lane_bce(logits, batch["y"])
        grads = torch.autograd.grad(losses.sum(), lane.leaves)
        opt.step(lane.flat, torch.cat([g.reshape(lane.K, -1) for g in grads], dim=1))
        return losses.detach()

    return update


def _keep(rates: np.ndarray, dtype: torch.dtype, device: torch.device, draw: bool | None = None):
    """Per-lane dropout keep probabilities as ``ops/nn.py::dropout`` uses
    them: float32 to compare with the uniform draw, rounded to the
    activations' dtype to scale by; None when nothing is drawn (``draw``,
    by default whether any of these lanes drops anything; a rank of a
    sharded group draws whenever a lane of the whole group does, and a lane
    at rate 0 keeps every unit of it unscaled)."""
    if not ((rates > 0).any() if draw is None else draw):
        return None
    keep = [1.0 - float(r) for r in rates]
    shape = (len(keep), 1, 1)
    return (torch.tensor(keep, dtype=torch.float32, device=device).view(shape),
            torch.tensor(keep, dtype=dtype, device=device).view(shape))


def run_group(
    splits: DatasetSplits,
    dims: ModelDims,
    mcfg: ModelConfig,
    tcfg: TrainConfig,
    trial_params: list[dict],
    report_fns: list | None = None,
    shard_lanes: bool = False,
    refill_fn=None,
    init_state: tuple | None = None,
    device: str | torch.device | None = None,
) -> list[VTrialResult]:
    """Train every trial in ``trial_params`` (which must share an
    ``arch_key``) as one K-lane program; returns per-trial results.

    ``mcfg``/``tcfg`` are the per-arch configs (emb/hidden/cross/res and
    batch/optimizer already applied); each trial's lr / weight_decay /
    dropout / plateau knobs are read from its own dict. ``report_fns[k]``
    is the trial-k pruning hook: ``fn(epoch, val_loss) -> should_prune``.
    ``init_state=(params, bn_state)`` (JAX-layout numpy trees) replaces the
    initialization of seed ``tcfg.seed`` in every lane, as in ``train_dcn``.
    ``device`` defaults to ``cuda`` and raises without a card.

    ``shard_lanes`` splits the trial axis over the ranks of the initialized
    world (one rank outside one; every rank calls this with the same
    arguments): K must be a multiple of the world size (``ValueError``, as
    in JAX). Every rank returns every trial's result.

    ``refill_fn`` enables lane reclamation: at each epoch boundary every
    newly-dead lane is finalized and refilled with a freshly asked
    same-architecture trial — ``refill_fn() -> (params_dict, report_fn) |
    None`` (None = trial budget exhausted; the lane then goes dormant). A
    refill resets the lane's parameters, BatchNorm state, moments, step
    count and best state to the shared init and its scalars to the new
    trial's; its plateau / early-stop / pruning clock runs on its own age,
    and its shuffle and dropout streams continue the group's from its join
    point. Returns one VTrialResult per trial ever run: the initial K
    first, then refills in ask order.
    """
    K = len(trial_params)
    keys = {arch_key(p) for p in trial_params}
    if len(keys) != 1:
        raise ValueError(f"trials span {len(keys)} architectures; group first")
    if tcfg.lazy_table_updates:
        raise ValueError("vectorized HPO does not support lazy_table_updates")
    if tcfg.rng_impl not in RNG_IMPLS:
        raise ValueError(f"unknown train.rng_impl {tcfg.rng_impl!r}")
    n, rank = 1, 0
    if shard_lanes:
        n, rank = lane_world()
        if K % n:
            raise ValueError(f"shard_lanes: group size {K} must be a multiple of the device count {n}")
    Kr = K // n  # this rank's lanes: [lo, lo + Kr)
    lo = rank * Kr
    mine = slice(lo, lo + Kr)
    report_fns = list(report_fns or [None] * K)
    dev = resolve_device(device)
    require_full_f32_matmul(dev)

    lrs = np.asarray([float(p["lr"]) for p in trial_params], np.float64)
    wds = np.asarray([float(p["weight_decay"]) for p in trial_params], np.float64)
    drs = np.asarray([float(p["dropout"]) for p in trial_params], np.float64)

    # Same init as the sequential trainer (train_dcn): every trial starts
    # from seed tcfg.seed, or from init_state.
    if init_state is not None:
        model = dcnr_from_jax(*init_state, dims, mcfg, dev, train=True)
    else:
        model = DCNR(dims, mcfg, generator=torch.Generator().manual_seed(tcfg.seed)).to(dev)
    lane = LaneDCNR(model, dims, Kr, plan_lanes=K if n > 1 else None)
    del model
    optimizer = str(trial_params[0]["optimizer"])
    update = _make_trial_update(optimizer)
    opt = LaneAdam(lane.flat, lrs[mine], wds[mine], decoupled=optimizer == "adamw")
    act_dtype = _DTYPES[mcfg.storage_dtype] or torch.float32
    keep = _keep(drs[mine], act_dtype, dev, draw=bool((drs > 0).any()))
    dropout_gen = torch.Generator(device=dev).manual_seed(tcfg.seed)

    train_data = split_tensors(splits, "train", dev)
    val_data = split_tensors(splits, "val", dev)
    B = tcfg.batch_size
    n_train = splits.n_train
    steps_per_epoch = n_train // B if tcfg.drop_remainder else -(-n_train // B)
    if steps_per_epoch == 0:
        raise ValueError(f"batch_size {B} > n_train {n_train} (set drop_remainder=False)")
    perm_len = steps_per_epoch * B

    plateaus = [PlateauScheduler(float(p["lr"]), int(p["lr_plateau_patience"]), float(p["lr_plateau_factor"]))
                for p in trial_params]
    results = [VTrialResult(params=None, bn_state=None) for _ in range(K)]
    lane_result: list = list(range(K))  # lane -> index into results
    active = np.ones(K, bool)
    no_improve = np.zeros(K, int)
    ages = np.zeros(K, int)  # epochs the lane's CURRENT trial has trained
    best = (lane.flat.detach().clone(), lane.flat_state.clone())  # never-improved lanes keep init
    shuffle_rng = np.random.default_rng(tcfg.seed)
    epoch_times: list = []
    first_epoch_time = None
    y_val = splits.val_y

    def metrics_of(lk: np.ndarray) -> dict:
        return {
            "val_logloss": float(bce_with_logits(torch.from_numpy(lk), torch.from_numpy(y_val.astype(np.float32)))),
            "val_auc": auc_score(y_val, lk),
            "val_rmse": rmse_of_probs(y_val, lk),
            "val_recall_at_100": recall_at_k(splits.val_user, y_val, lk, 100),
        }

    def finalize_lanes(ks: list, logits: np.ndarray | None = None) -> None:
        """Final metrics and weights of lanes ``ks``' trials from their best
        states: this rank finalizes its own lanes (``logits``: its lanes' val
        logits, else each lane alone through the single-trial eval), then
        every rank gets every one. Pruned lanes are skipped: the HPO CLI
        discards them."""
        done = {}
        for k in ks:
            if results[lane_result[k]].pruned or not lo <= k < lo + Kr:
                continue
            model_k = lane.lane_model(k - lo, *best)
            params, bn_state = jax_from_dcnr(model_k)
            lk = (logits[k - lo] if logits is not None
                  else eval_logits(model_k, val_data, tcfg.eval_batch_size).cpu().numpy())
            done[lane_result[k]] = (params, bn_state, metrics_of(lk))
        if n > 1:
            every = [None] * n
            dist.all_gather_object(every, done)
            done = {i: v for part in every for i, v in part.items()}
        for i, (params, bn_state, metrics) in done.items():
            results[i].params, results[i].bn_state, results[i].final_metrics = params, bn_state, metrics

    while active.any():
        t_epoch = time.perf_counter()
        perm_host = shuffle_rng.permutation(n_train)
        if perm_len > n_train:
            perm_host = np.resize(perm_host, perm_len)  # wrap-pad the ragged tail
        perm = torch.as_tensor(perm_host[:perm_len], dtype=torch.int64, device=dev)
        losses = []
        for s in range(steps_per_epoch):
            idx = perm[s * B:(s + 1) * B]
            losses.append(update(lane, opt, {k: v[idx] for k, v in train_data.items()}, keep, dropout_gen))
        mean_train = sum(losses[1:], losses[0]) / len(losses)  # lane by lane, in step order, whatever K is
        val_losses = lane_bce(lane_eval_logits(lane, val_data, tcfg.eval_batch_size), val_data["y"])
        both = torch.stack([val_losses, mean_train], dim=1)  # [Kr, 2]
        if n > 1:
            both = all_gather(both).flatten(0, 1)  # every lane's, in lane order
        val_losses, train_losses = (np.asarray(x, np.float64) for x in both.T.tolist())

        improved = np.zeros(K, bool)
        for k in range(K):
            if not active[k]:
                continue
            vl = float(val_losses[k])
            lrs[k] = plateaus[k].step(vl)
            r = results[lane_result[k]]
            age = int(ages[k])
            r.history.append({"epoch": age, "train_loss": float(train_losses[k]), "val_loss": vl,
                              "lr": float(lrs[k])})
            if vl < r.best_val_loss:
                r.best_val_loss, r.best_epoch = vl, age
                no_improve[k] = 0
                improved[k] = True
            else:
                no_improve[k] += 1
            ages[k] += 1
            if report_fns[k] is not None and report_fns[k](age, vl):
                r.pruned = True
                active[k] = False
                log.info("vectorized trial lane %d pruned at epoch %d", k, age)
            elif no_improve[k] >= tcfg.early_stop_patience:
                active[k] = False
                log.info("vectorized trial lane %d early-stopped at epoch %d", k, age + 1)
            elif ages[k] >= tcfg.n_epochs:
                active[k] = False  # trial completed its epoch budget
        opt.set_lanes(lrs[mine])

        if improved[mine].any():
            with torch.no_grad():
                mask = torch.as_tensor(improved[mine], device=dev)[:, None]
                best = (torch.where(mask, lane.flat, best[0]), torch.where(mask, lane.flat_state, best[1]))

        if first_epoch_time is None:  # the first epoch warms up (builds the kernels, plans)
            first_epoch_time = time.perf_counter() - t_epoch
        else:
            epoch_times.append(time.perf_counter() - t_epoch)

        # Lane reclamation: finalize every newly-dead lane, then refill it
        # with a freshly asked same-architecture trial if the budget allows;
        # an unrefilled lane goes dormant. Without refill_fn the dead lanes
        # finalize once, after the loop.
        if refill_fn is not None:
            dead = [k for k in range(K) if not active[k] and lane_result[k] is not None]
            if dead:
                finalize_lanes(dead)
            for k in dead:
                ask = refill_fn()
                if ask is None:
                    lane_result[k] = None  # dormant: budget exhausted
                    continue
                new_params, new_report = ask
                if arch_key(new_params) != arch_key(trial_params[0]):
                    raise ValueError("refill_fn returned a trial with a different architecture than the "
                                     "running group")
                lrs[k] = float(new_params["lr"])
                wds[k] = float(new_params["weight_decay"])
                drs[k] = float(new_params["dropout"])
                plateaus[k] = PlateauScheduler(float(new_params["lr"]), int(new_params["lr_plateau_patience"]),
                                               float(new_params["lr_plateau_factor"]))
                report_fns[k] = new_report
                no_improve[k] = 0
                ages[k] = 0
                results.append(VTrialResult(params=None, bn_state=None))
                lane_result[k] = len(results) - 1
                active[k] = True
                opt.set_lanes(lrs[mine], wds[mine])
                keep = _keep(drs[mine], act_dtype, dev, draw=bool((drs > 0).any()))
                if lo <= k < lo + Kr:
                    lane.reset_lane(k - lo)
                    opt.reset_lane(k - lo)
                    with torch.no_grad():
                        best[0][k - lo].copy_(lane.init)
                        best[1][k - lo].copy_(lane.init_state)
                log.info("vectorized lane %d reclaimed for a new trial", k)

    # Lanes not finalized above: every lane of a group without refill_fn.
    # Each rank's lanes share ONE eval of their best states and one copy back.
    pending = [k for k in range(K) if lane_result[k] is not None]
    if pending:
        with torch.no_grad():
            lane.flat.copy_(best[0])
            lane.flat_state.copy_(best[1])
        finalize_lanes(pending, logits=lane_eval_logits(lane, val_data, tcfg.eval_batch_size).cpu().numpy())
        for k in pending:
            lane_result[k] = None

    rate = 0.0
    if epoch_times:
        rate = steps_per_epoch * B / max(statistics.median(epoch_times), 1e-9)
    elif first_epoch_time is not None:
        # single-epoch groups have only the warm-up epoch to report
        rate = steps_per_epoch * B / max(first_epoch_time, 1e-9)
    for r in results:
        r.examples_per_s = rate
        r.group_examples_per_s = rate * K
    return results


def lane_world() -> tuple[int, int]:
    """``(ranks, this rank)`` of the world a sharded group splits its lanes
    over: the initialized ``torch.distributed`` world, or this process alone."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0
