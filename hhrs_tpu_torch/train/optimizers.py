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
"""

from __future__ import annotations

import torch


def make_optimizer(name: str, params, lr: float, weight_decay: float,
                   capturable_on: torch.device | None = None) -> torch.optim.Optimizer:
    """``capturable_on``: a CUDA device whose parameters these are, for the
    CUDA-graph form (LR tensor there, ``capturable=True``)."""
    name = name.lower()
    if name not in ("adamw", "adam"):
        raise ValueError(f"unknown optimizer {name!r}")
    kind = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
    extra = {}
    if capturable_on is not None:
        extra = dict(lr=torch.tensor(lr, dtype=torch.float32, device=capturable_on), capturable=True)
    return kind(params, **{"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8, "weight_decay": weight_decay,
                           "foreach": True, **extra})


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
