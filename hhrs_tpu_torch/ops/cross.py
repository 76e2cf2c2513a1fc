"""Feature-cross stack (counterpart of ``hhrs_tpu/ops/cross.py``).

Weights for all L layers are stacked ``[L, d]``. Two variants:
``code``: ``x_{l+1} = x_l + x_l * (w_l · x_l) + b_l``;
``canonical``: ``x_{l+1} = x_0 * (w_l · x_l) + b_l + x_l``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

CROSS_VARIANTS = ("code", "canonical")


def cross_stack_apply(w: torch.Tensor, b: torch.Tensor, x0: torch.Tensor, variant: str) -> torch.Tensor:
    if variant not in CROSS_VARIANTS:
        raise ValueError(f"unknown cross variant {variant!r}")
    x = x0
    for l in range(w.shape[0]):
        gate = (x * w[l]).sum(dim=1, keepdim=True)  # [B, 1] scalar gate per row
        if variant == "code":
            x = x + x * gate + b[l]
        else:
            x = x0 * gate + b[l] + x
    return x


class CrossStack(nn.Module):
    def __init__(self, n_layers: int, dim: int, variant: str = "code",
                 generator: torch.Generator | None = None):
        super().__init__()
        if variant not in CROSS_VARIANTS:
            raise ValueError(f"unknown cross variant {variant!r}")
        self.variant = variant
        bound = 1.0 / math.sqrt(dim)
        self.w = nn.Parameter(torch.empty(n_layers, dim))
        self.b = nn.Parameter(torch.zeros(n_layers, dim))
        with torch.no_grad():
            self.w.uniform_(-bound, bound, generator=generator)

    def forward(self, x0: torch.Tensor) -> torch.Tensor:
        return cross_stack_apply(self.w, self.b, x0, self.variant)
