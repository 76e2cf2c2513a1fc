"""Sharded similarity retrieval: a row-sharded item table, a top-k per
shard, one global merge.

Counterpart of ``hhrs_tpu/retrieval/sharded.py``. The exact-top-k identity:
the global top-k over N rows is the top-k over the union of every shard's
local top-k. So each rank scores a ``[Q, N/W]`` panel of its own rows,
keeps its local top-``k_local``, one ``all_gather`` moves the ``[W, Q,
k_local]`` (score, global index) pairs in one collective, and a stable top-k merges them:
O(W·Q·k) bytes on the wire instead of O(Q·N). Ties keep the lower global
index, as ``cosine_topk`` and ``lax.top_k`` do (shards are in index order,
each shard's pairs sorted stably).
"""

from __future__ import annotations

import torch

from hhrs_tpu_torch.parallel.mesh import all_gather, mesh_size, shard_index
from hhrs_tpu_torch.retrieval.similarity import normalize_rows, require_full_f32_matmul, topk_stable


def shard_k(k: int, n_rows: int, shards: int) -> int:
    """Pairs each shard of ``n_rows // shards`` rows contributes to a top-k:
    ``min(k, rows per shard)``. Raises when the shards together cannot
    hold k rows."""
    rows_per = n_rows // shards
    k_local = min(k, rows_per)
    if shards * k_local < k:
        raise ValueError(
            f"top-k {k} impossible: table has {n_rows} rows "
            f"({rows_per} per shard x {shards} shards = {shards * rows_per} candidates)")
    return k_local


def merge_topk(vals: torch.Tensor, idx: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Gathered ``[W, Q, k_local]`` shard top-k pairs → the global ``[Q, k]``."""
    W, Q, kl = vals.shape
    all_vals = vals.permute(1, 0, 2).reshape(Q, W * kl)
    all_idx = idx.permute(1, 0, 2).reshape(Q, W * kl)
    best_vals, pos = topk_stable(all_vals, k)
    return best_vals, torch.gather(all_idx, 1, pos)


def sharded_cosine_topk(mesh, table_norm_local: torch.Tensor, queries: torch.Tensor, k: int,
                        n_valid: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k cosine neighbours over a table row-sharded on ``mesh``:
    ``table_norm_local`` is this rank's ``[N/W, d]`` rows (L2-normalized) of
    the ``[N, d]`` table, ``queries`` ``[Q, d]`` raw and the same on every
    rank. Rows at or past ``n_valid`` (a table padded to the shard count)
    score ``-inf``. Returns (scores, global indices) ``[Q, k]`` on every
    rank, equal (up to tie order) to ``cosine_topk`` on the whole table."""
    W = mesh_size(mesh)
    rows_per = table_norm_local.shape[0]
    k_local = shard_k(k, rows_per * W, W)
    require_full_f32_matmul(table_norm_local.device)
    sims = normalize_rows(queries) @ table_norm_local.T  # [Q, N/W]
    offset = shard_index(mesh) * rows_per
    gidx = offset + torch.arange(rows_per, device=sims.device)
    if n_valid is not None:
        sims = torch.where((gidx < n_valid)[None, :], sims, torch.full((), float("-inf"), device=sims.device))
    vals, pos = topk_stable(sims, k_local)
    # one gather of (score, index) pairs; f64 holds both exactly
    pairs = all_gather(torch.stack([vals.double(), gidx[pos].double()]))  # [W, 2, Q, k_local]
    best, idx = merge_topk(pairs[:, 0].float(), pairs[:, 1].long(), k)
    return best, idx


def make_sharded_topk_fn(mesh, k: int, n_valid: int | None = None):
    """``fn(table_norm_local, queries) -> (scores, indices)`` for one ``k``.
    ``n_valid`` must be given whenever the table was padded up to the
    shard count (``pad_to_shards``): zero padding rows (cosine 0.0) would
    otherwise beat an all-negative neighbourhood."""

    def fn(table_norm_local, queries):
        return sharded_cosine_topk(mesh, table_norm_local, queries, k, n_valid=n_valid)

    return fn
