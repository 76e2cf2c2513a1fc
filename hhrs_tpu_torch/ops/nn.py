"""Primitive layers with the JAX package's parameter layout and semantics.

Counterpart of ``hhrs_tpu/ops/nn.py``. ``Linear.kernel`` is ``[in, out]``
(``y = x @ kernel + bias``) so one weight tree serves both packages.
``BatchNorm`` keeps the JAX/torch-BatchNorm1d semantics: the centred batch
variance normalizes, the unbiased one updates the running variance
(momentum 0.1 by default), and training on a batch of one raises.
Initialization follows the same distributions: linear ~ U(±1/sqrt(fan_in)),
embedding ~ N(0, 1), BatchNorm scale 1 / bias 0 / mean 0 / var 1.

The dtype rules are the JAX package's: ``Linear`` casts its operands to
``compute_dtype``, multiplies them with an f32 product and f32 sums
(``preferred_element_type=f32``), adds the bias in f32 and only then casts
to ``out_dtype``; ``BatchNorm`` computes its statistics and normalization in
f32, keeps its running state f32 and casts only its output back;
``dropout`` keeps its input's dtype. Parameters stay f32 throughout.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class Linear(nn.Module):
    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator | None = None):
        super().__init__()
        bound = 1.0 / math.sqrt(fan_in)
        self.kernel = nn.Parameter(torch.empty(fan_in, fan_out))
        self.bias = nn.Parameter(torch.empty(fan_out))
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype | None = None,
                out_dtype: torch.dtype | None = None) -> torch.Tensor:
        k = self.kernel
        if compute_dtype is not None:
            x, k = x.to(compute_dtype), k.to(compute_dtype)
        # A product of two bf16 values is exact in f32, so multiplying the
        # upcast operands is JAX's bf16 product with f32 accumulation (up to
        # summation order), on the CPU and on the card alike.
        y = x.float() @ k.float() + self.bias
        return y if out_dtype is None else y.to(out_dtype)


def embedding_table(n_rows: int, dim: int, generator: torch.Generator | None = None) -> nn.Parameter:
    table = nn.Parameter(torch.empty(n_rows, dim))
    with torch.no_grad():
        table.normal_(generator=generator)
    return table


class BatchNorm(nn.Module):
    """Parameters ``scale``/``bias``; running statistics as the buffers
    ``mean``/``var`` (the JAX package's ``bn_state``)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return ((xf - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias).to(x.dtype)
        n = x.shape[0]
        if n <= 1:
            raise ValueError(
                "BatchNorm training needs >1 example per batch (torch BatchNorm1d parity)"
            )
        mean = xf.mean(dim=0)
        var_biased = (xf - mean).square().mean(dim=0)
        var_unbiased = var_biased * (n / max(n - 1, 1))
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_((1 - m) * self.mean + m * mean)
            self.var.copy_((1 - m) * self.var + m * var_unbiased)
        return ((xf - mean) * torch.rsqrt(var_biased + self.eps) * self.scale + self.bias).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on ``x``'s device), in
    ``x``'s dtype: the keep probability is rounded to it first, as JAX does."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    keep_x = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep_x, torch.zeros((), dtype=x.dtype, device=x.device))
