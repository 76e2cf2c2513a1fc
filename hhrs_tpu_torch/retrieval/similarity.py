"""Item-embedding similarity: exact brute-force cosine top-k.

Counterpart of ``hhrs_tpu/retrieval/similarity.py``. Ties keep the lower
index first, as ``lax.top_k`` does: the top-k is a stable descending sort,
sliced. Products run in full float32 (TF32 off and checked on CUDA).
"""

from __future__ import annotations

import numpy as np
import torch


def require_full_f32_matmul(device: torch.device) -> None:
    """Turn TF32 off for CUDA matrix products and check it stayed off:
    TF32 keeps about three digits, and cosine ties and MMR picks would
    then differ from the float32 reference."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 matmul could not be disabled")


def normalize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def topk_stable(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis, ties to the lower index (``lax.top_k``)."""
    if k > x.shape[-1]:
        raise ValueError(f"k={k} exceeds the axis size {x.shape[-1]}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def cosine_topk(table_norm: torch.Tensor, queries: torch.Tensor, k: int):
    """Top-k cosine neighbours of each query row against a pre-normalized
    table. table_norm ``[N, d]``; queries ``[Q, d]`` (normalized here).
    Returns (scores ``[Q, k]``, indices ``[Q, k]``) sorted descending."""
    require_full_f32_matmul(table_norm.device)
    sims = normalize_rows(queries) @ table_norm.T
    return topk_stable(sims, k)


def build_neighbor_table(embeddings: torch.Tensor, k: int, batch: int = 1024) -> np.ndarray:
    """For each item its top-k neighbours *excluding the first hit* (the
    reference drops hit 0 assuming it is the item itself). Catalogs with
    ≤ k items pad the missing columns with N, the caller's dump slot.
    Returns ``[N, k]`` int32 on the host."""
    emb = embeddings.float()
    n = int(emb.shape[0])
    if n == 0:
        return np.zeros((0, k), np.int32)
    kk = min(k + 1, n)
    table_norm = normalize_rows(emb)
    chunks = [cosine_topk(table_norm, emb[s:s + batch], kk)[1] for s in range(0, n, batch)]
    table = torch.cat(chunks)[:, 1:].cpu().numpy().astype(np.int32)
    if table.shape[1] < k:
        table = np.concatenate([table, np.full((n, k - table.shape[1]), n, np.int32)], axis=1)
    return table
