"""Optimizers and plateau LR control (counterpart of
``hhrs_tpu/train/optimizers.py``).

* ``adamw``: ``torch.optim.AdamW(weight_decay=wd, eps=1e-8)``, decoupled
  decay on every parameter, the same update as optax's ``adamw``;
* ``adam``: ``torch.optim.Adam(weight_decay=wd)``, the L2-coupled form
  (``wd·p`` added to the gradient before the moments) that the JAX
  package builds with ``optax.chain(add_decayed_weights, scale_by_adam, …)``.

Both run the ``foreach`` implementation (one multi-tensor launch per
update stage); the ``fused`` one is not used. The learning rate lives in
``param_groups``: :func:`set_learning_rate` writes it, so a plateau decay
needs nothing rebuilt. ``capturable=True`` builds the form a CUDA graph can
replay: the step counts and the learning rate are tensors on the card (the
bias corrections are computed there), and the LR is written in place.
The JAX package leaves the optimizer to XLA, with no Pallas kernel, so
``torch.optim`` is its counterpart.

``moment_dtype="bfloat16"`` (optax's ``mu_dtype``) stores Adam's first
moment in bf16 and nothing else: :class:`AdamBf16Moment`, the same two
updates with the first moment kept in bf16 between steps. ``torch.optim``
has no such option.
"""

from __future__ import annotations

import torch


MOMENT_DTYPES = ("float32", "bfloat16")


def make_optimizer(name: str, params, lr: float, weight_decay: float,
                   capturable_on: torch.device | None = None,
                   moment_dtype: str = "float32") -> torch.optim.Optimizer:
    """``capturable_on``: a CUDA device whose parameters these are, for the
    CUDA-graph form (LR tensor there, ``capturable=True``);
    ``moment_dtype``: the first moment's storage dtype."""
    name = name.lower()
    if name not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer {name!r}")
    if moment_dtype not in MOMENT_DTYPES:
        raise ValueError(f"unknown train.moment_dtype {moment_dtype!r}; expected one of {MOMENT_DTYPES}")
    extra = {}
    if capturable_on is not None:
        extra = dict(lr=torch.tensor(lr, dtype=torch.float32, device=capturable_on), capturable=True)
    kw = {"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": weight_decay, **extra}
    if moment_dtype == "bfloat16":
        return AdamBf16Moment(params, decoupled=name == "adamw", **kw)
    kind = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    return kind(params, foreach=True, **kw)


class AdamBf16Moment(torch.optim.Optimizer):
    """Adam (``decoupled=False``: ``wd·p`` added to the gradient) or AdamW
    (``decoupled=True``: ``p·(1 − lr·wd)`` first) with the first moment
    stored in bf16, with optax's ``mu_dtype`` semantics:

    * ``mu = (1 − b1)·g + b1·mu`` in f32, where ``b1·mu`` is a bf16 product
      (optax multiplies the bf16 moment by the weak-typed Python ``b1``, so
      JAX rounds that product to bf16 before the f32 sum);
    * this step's update reads that f32 ``mu``; it is rounded to bf16 only
      to be stored;
    * the second moment stays f32.

    The update otherwise takes ``torch.optim.Adam``'s ``foreach`` steps in
    its order (the bias corrections in Python floats, or on the card with
    ``capturable=True``, where the step counts and the LR are tensors there
    and a CUDA graph replays the step)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0, decoupled=True,
                 capturable=False):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps, weight_decay=weight_decay,
                                      decoupled=decoupled, capturable=capturable))
        self._b1_bf16: dict = {}  # device -> b1 as a bf16 tensor there (made before any capture)

    def _init_state(self, p: torch.Tensor, capturable: bool) -> dict:
        state = self.state[p]
        if not state:
            state["step"] = torch.zeros((), dtype=torch.float32, device=p.device if capturable else "cpu")
            state["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
            state["exp_avg_sq"] = torch.zeros_like(p)
        return state

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        for state in self.state.values():  # the base class casts moments to the parameter's dtype
            state["exp_avg"] = state["exp_avg"].to(torch.bfloat16)

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            capturable = group["capturable"]
            states = [self._init_state(p, capturable) for p in params]
            grads = [p.grad for p in params]
            steps = [s["step"] for s in states]
            mus = [s["exp_avg"] for s in states]
            nus = [s["exp_avg_sq"] for s in states]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            b1, b2 = group["betas"]
            dev = params[0].device
            if dev not in self._b1_bf16:
                self._b1_bf16[dev] = torch.tensor(b1, dtype=torch.bfloat16, device=dev)

            torch._foreach_add_(steps, 1)
            if wd != 0:
                if group["decoupled"]:
                    torch._foreach_mul_(params, 1 - lr * wd)
                else:
                    grads = torch._foreach_add(grads, params, alpha=wd)
            mu32 = torch._foreach_mul(grads, 1 - b1)
            torch._foreach_add_(mu32, torch._foreach_mul(mus, self._b1_bf16[dev]))  # b1·mu rounded to bf16
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, 1 - b2)
            denom = torch._foreach_sqrt(nus)
            if capturable:
                bc1 = torch._foreach_pow(b1, steps)
                bc2 = torch._foreach_pow(b2, steps)
                torch._foreach_sub_(bc1, 1)  # b1^t − 1 = −(1 − b1^t)
                torch._foreach_sub_(bc2, 1)
                torch._foreach_neg_(bc2)
                torch._foreach_sqrt_(bc2)
                torch._foreach_div_(denom, bc2)
                torch._foreach_add_(denom, eps)
                torch._foreach_div_(bc1, lr)  # −(1 − b1^t)/lr: the reciprocal of the step size
                torch._foreach_mul_(denom, bc1)
                torch._foreach_addcdiv_(params, mu32, denom)
            else:
                bc1 = [1 - b1 ** s.item() for s in steps]
                bc2_sqrt = [(1 - b2 ** s.item()) ** 0.5 for s in steps]
                torch._foreach_div_(denom, bc2_sqrt)
                torch._foreach_add_(denom, eps)
                torch._foreach_addcdiv_(params, mu32, denom, [(lr / bc) * -1 for bc in bc1])
            torch._foreach_copy_(mus, mu32)  # rounded to bf16 for storage
        return None


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)  # in place: a captured graph reads this tensor
        else:
            group["lr"] = lr


def get_learning_rate(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


class PlateauScheduler:
    """ReduceLROnPlateau('min') parity: shrink LR by `factor` after
    `patience` epochs without improvement beyond a relative threshold."""

    def __init__(self, lr: float, patience: int, factor: float, threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        """Feed an epoch metric; returns the (possibly reduced) LR."""
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr
