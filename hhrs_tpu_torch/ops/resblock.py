"""Residual block Linear→BN→ReLU→Dropout→Linear→BN (+identity)→ReLU, and
the plain-MLP ablation block Linear→ReLU→Dropout (counterpart of
``hhrs_tpu/ops/resblock.py`` and the ``dcn_mlp`` branch of ``models/dcn.py``).
Both pass ``compute_dtype`` and ``out_dtype`` on to their linears, and
``rows`` (a rank's rows of a global batch) on to ``dropout``."""

from __future__ import annotations

import torch
from torch import nn

from hhrs_tpu_torch.ops.nn import BatchNorm, Linear, dropout


class ResBlock(nn.Module):
    def __init__(self, hidden: int, momentum: float = 0.1, eps: float = 1e-5,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.layer1 = Linear(hidden, hidden, generator)
        self.bn1 = BatchNorm(hidden, momentum, eps)
        self.layer2 = Linear(hidden, hidden, generator)
        self.bn2 = BatchNorm(hidden, momentum, eps)

    def forward(self, x: torch.Tensor, rate: float, generator: torch.Generator | None,
                compute_dtype: torch.dtype | None = None, out_dtype: torch.dtype | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        h = torch.relu(self.bn1(self.layer1(x, compute_dtype, out_dtype)))
        if self.training:
            h = dropout(h, rate, generator, rows)
        h = self.bn2(self.layer2(h, compute_dtype, out_dtype))
        return torch.relu(h + x)


class MLPBlock(nn.Module):
    def __init__(self, hidden: int, generator: torch.Generator | None = None):
        super().__init__()
        self.layer = Linear(hidden, hidden, generator)

    def forward(self, x: torch.Tensor, rate: float, generator: torch.Generator | None,
                compute_dtype: torch.dtype | None = None, out_dtype: torch.dtype | None = None,
                rows: tuple[int, int] | None = None) -> torch.Tensor:
        h = torch.relu(self.layer(x, compute_dtype, out_dtype))
        return dropout(h, rate, generator, rows) if self.training else h
