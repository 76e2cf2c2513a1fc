"""Primitive layers with the JAX package's parameter layout and semantics.

Counterpart of ``hhrs_tpu/ops/nn.py``. ``Linear.kernel`` is ``[in, out]``
(``y = x @ kernel + bias``) so one weight tree serves both packages.
``BatchNorm`` keeps the JAX/torch-BatchNorm1d semantics: the centred batch
variance normalizes, the unbiased one updates the running variance
(momentum 0.1 by default), and training on a batch of one raises. On a
training mesh a ``BatchNorm`` whose ``group`` is the ``data`` axis's
process group takes its statistics over the whole global batch (sync
BatchNorm); ``dropout`` with ``rows`` draws the whole global batch's mask
and keeps this rank's rows of it, so both give what one device gives on
the concatenated rows.
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

from hhrs_tpu_torch.parallel.mesh import AllReduceSum


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
    ``mean``/``var`` (the JAX package's ``bn_state``). ``group``: None, or
    the process group whose ranks each hold an equal share of the batch's
    rows (the ``data`` axis of a training mesh); train mode then computes
    the statistics over all of them in the same two passes, the global mean
    first (one ``all_reduce`` of the row sums), then the global biased
    variance (one of the squared deviations' sums), and the backward sums
    through the same group (``parallel/mesh.py::AllReduceSum``)."""

    def __init__(self, dim: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if not self.training:
            return ((xf - self.mean) * torch.rsqrt(self.var + self.eps) * self.scale + self.bias).to(x.dtype)
        n = x.shape[0]
        if self.group is not None:
            n *= torch.distributed.get_world_size(self.group)
        if n <= 1:
            raise ValueError(
                "BatchNorm training needs >1 example per batch (torch BatchNorm1d parity)"
            )
        if self.group is None:
            mean = xf.mean(dim=0)
            var_biased = (xf - mean).square().mean(dim=0)
        else:
            mean = AllReduceSum.apply(xf.sum(dim=0), self.group) / n
            var_biased = AllReduceSum.apply((xf - mean).square().sum(dim=0), self.group) / n
        var_unbiased = var_biased * (n / max(n - 1, 1))
        with torch.no_grad():
            m = self.momentum
            self.mean.copy_((1 - m) * self.mean + m * mean)
            self.var.copy_((1 - m) * self.var + m * var_unbiased)
        return ((xf - mean) * torch.rsqrt(var_biased + self.eps) * self.scale + self.bias).to(x.dtype)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """Inverted dropout with an explicit generator (on ``x``'s device), in
    ``x``'s dtype: the keep probability is rounded to it first, as JAX does.
    ``rows = (start, total)``: ``x`` is rows ``[start, start + len(x))`` of a
    global batch of ``total``; the mask of all ``total`` rows is drawn and
    these rows of it are kept, so every rank's generator stays in step."""
    if rate <= 0.0:
        return x
    keep = 1.0 - rate
    if rows is None:
        mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    else:
        start, total = rows
        mask = (torch.rand((total, *x.shape[1:]), generator=generator, device=x.device) < keep)[
            start:start + x.shape[0]]
    keep_x = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep_x, torch.zeros((), dtype=x.dtype, device=x.device))
