"""Per-row symmetric int8 embedding tables (counterpart of
``hhrs_tpu/ops/quant.py``), the serve engine's ``quantize_tables`` option.

A row is ``values[i] * scales[i]`` with ``scales = absmax / 127`` (1 for a
zero row) and ``values = clamp(round(row / scale), -127, 127)``, rounded
half to even: the same f32 operations as the JAX package, so the int8
values and scales are bitwise JAX's. A lookup gathers the int8 rows and
their scales and dequantizes them in f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class QuantizedTable(nn.Module):
    """Per-row symmetric int8 table: buffers ``values [N, D]`` int8 and
    ``scales [N]`` f32; row ``i`` is ``values[i] * scales[i]``."""

    def __init__(self, values: torch.Tensor, scales: torch.Tensor):
        super().__init__()
        if values.dtype != torch.int8 or values.dim() != 2 or scales.shape != values.shape[:1]:
            raise ValueError(f"QuantizedTable takes int8 values [N, D] and scales [N], got "
                             f"{values.dtype} {tuple(values.shape)} and {tuple(scales.shape)}")
        self.register_buffer("values", values)
        self.register_buffer("scales", scales.float())

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    def nbytes(self) -> int:
        return self.values.numel() + self.scales.numel() * 4


def _f32(table) -> torch.Tensor:
    return table.float() if isinstance(table, torch.Tensor) else torch.tensor(np.asarray(table), dtype=torch.float32)


def quantize_table(table) -> QuantizedTable:
    """``[N, D]`` float table (tensor or array) → per-row int8 + scales."""
    table = _f32(table)
    absmax = table.abs().amax(dim=1)
    scales = torch.where(absmax > 0, absmax / 127.0, torch.ones((), device=table.device))
    q = torch.clamp(torch.round(table / scales[:, None]), -127, 127).to(torch.int8)
    return QuantizedTable(q, scales)


def dequantize(qt: QuantizedTable) -> torch.Tensor:
    return qt.values.float() * qt.scales[:, None]


def quantized_lookup(qt: QuantizedTable, ids: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize the rows ``ids`` (any shape) → ``[*ids.shape, D]`` f32."""
    return qt.values[ids].float() * qt.scales[ids][..., None]


def table_lookup(table, ids: torch.Tensor) -> torch.Tensor:
    """The model's one row gather: a plain ``[N, D]`` table or a
    :class:`QuantizedTable`."""
    if isinstance(table, QuantizedTable):
        return quantized_lookup(table, ids)
    return table[ids]


def quantize_embedding_params(params: dict) -> dict:
    """A copy of a JAX-layout params tree with the embedding tables (user,
    item, each categorical) as :class:`QuantizedTable`s; the dense tower
    weights stay f32. ``models/convert.py::dcnr_from_jax`` takes the result."""
    out = dict(params)
    out["user_embedding"] = quantize_table(params["user_embedding"])
    out["item_embedding"] = quantize_table(params["item_embedding"])
    cats = params["cat_embeddings"]  # a list, or the msgpack form's {"0": …, "1": …}
    out["cat_embeddings"] = ({k: quantize_table(t) for k, t in cats.items()} if isinstance(cats, dict)
                             else [quantize_table(t) for t in cats])
    return out


def quantization_error(table) -> float:
    """Largest relative row-norm error of the int8 round trip."""
    table = _f32(table)
    deq = dequantize(quantize_table(table))
    num = torch.linalg.norm(deq - table, dim=1)
    den = torch.clamp(torch.linalg.norm(table, dim=1), min=1e-12)
    return float((num / den).max())
