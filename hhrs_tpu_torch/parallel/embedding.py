"""Row-sharded embedding lookups with the exchanges written out
(counterpart of ``hhrs_tpu/parallel/embedding.py``).

A table row-sharded over the ``model`` axis (``parallel/sharding.py``)
holds rows ``[j·R/m, (j+1)·R/m)`` on the ranks of model coordinate ``j``.
Three exchanges fetch the rows of a batch, each differentiable, each
ending its backward in a scatter-add onto the owning shard, so table
gradients stay on their shard:

* :func:`psum_lookup`: every model rank gathers the rows it owns of its
  data rows' ids (zeros for the rest) and the partial results are summed
  over the ``model`` group (one ``all_reduce``). The model ranks then hold
  the same rows and compute the same loss, so the backward passes the
  gradient on unsummed (:class:`~hhrs_tpu_torch.parallel.mesh.ReplicatedSum`).
  This is the port's default exchange: the JAX package's default is
  GSPMD's lowering of ``table[ids]``, which its docstring calls
  essentially this form, and the port has no GSPMD.
* :func:`all_to_all_lookup`: the two-hop id/vector exchange. The ids are
  split over both axes (``P((data, model))``: model rank ``j`` takes piece
  ``j`` of its data rows); each rank buckets its ids by owner at the worst
  case capacity (every id to one owner), one ``all_to_all`` sends the ids,
  the owners gather, a second sends the vectors back.
* :func:`capped_all_to_all_lookup`: the same at a capacity of
  ``ceil(b/m · capacity_factor)`` ids a bucket; an id past its bucket's
  capacity (by its rank in the bucket, in row order) is dropped: a zero
  row and no gradient. Factor ``m`` is the exact exchange.

:func:`explicit_x0` assembles the DCN-R input from them over this rank's
data rows: the row-sharded tables through the exchange, the replicated
ones by a local gather, the all_to_all pieces put back together over the
``model`` group (one ``all_gather``). The tables of one batch share each
collective (their columns side by side), so an exchange is one
``all_reduce`` (psum) or two ``all_to_all`` and one ``all_gather``
forward, whatever the number of tables. All three are exact for ids in
``[0, rows)``: the same bits as the single-device gather.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from hhrs_tpu_torch.parallel.mesh import AllToAll, GatherRows, ReplicatedSum, all_reduce
from hhrs_tpu_torch.parallel.sharding import MeshLayout, table_names

EXCHANGES = ("psum", "all_to_all", "capped")


def pad_table(table: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``table`` with zero rows appended up to a multiple of ``n_shards``."""
    pad = (-table.shape[0]) % n_shards
    return table if pad == 0 else torch.cat([table, table.new_zeros(pad, *table.shape[1:])])


def _owned_rows(shard: torch.Tensor, ids: torch.Tensor, start: int) -> torch.Tensor:
    """The rows of ``shard`` (whole rows ``[start, start + len(shard))``) that
    ``ids`` name, zeros where another shard owns the id."""
    local = ids - start
    owned = (local >= 0) & (local < shard.shape[0])
    emb = shard[local.clamp(0, shard.shape[0] - 1)]
    return torch.where(owned[:, None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device))


def psum_lookup(layout: MeshLayout, shards: list, ids: list) -> list:
    """Masked gather and one sum over the ``model`` group: ``shards[t]`` is
    this rank's shard of table ``t``, ``ids[t]`` the ids ``[n]`` of this
    rank's data rows → each table's rows ``[n, D_t]``, the same on every
    model rank."""
    parts = [_owned_rows(s, i, layout.model_rank * s.shape[0]) for s, i in zip(shards, ids)]
    summed = ReplicatedSum.apply(torch.cat(parts, dim=1), layout.model_group)
    return list(summed.split([p.shape[1] for p in parts], dim=1))


def _buckets(ids: torch.Tensor, rows_per: int, m: int) -> tuple:
    """``(owner, rank)`` of each id: the model rank that owns it, and its
    place among the ids of that owner, in row order."""
    owner = torch.clamp(torch.div(ids, rows_per, rounding_mode="floor"), 0, m - 1)
    oh = F.one_hot(owner, m)
    rank = (torch.cumsum(oh, dim=0) * oh).sum(dim=1) - 1
    return owner, rank


def _exchange(layout: MeshLayout, shards: list, ids: list, capacity: int) -> tuple:
    """The two hops for every table at once at ``capacity`` ids a bucket →
    (each table's rows ``[b, D_t]`` with dropped ids zero, each table's
    dropped mask ``[b]``)."""
    m, group = layout.model_size, layout.model_group
    T = len(shards)
    owners, ranks, kept = [], [], []
    send = torch.full((m, T, capacity), -1, dtype=torch.int64, device=ids[0].device)
    for t, (s, i) in enumerate(zip(shards, ids)):
        owner, rank = _buckets(i, s.shape[0], m)
        keep = rank < capacity
        send[owner[keep], t, rank[keep]] = i[keep] - owner[keep] * s.shape[0]
        owners.append(owner)
        ranks.append(rank.clamp(max=capacity - 1))
        kept.append(keep)
    # hop 1: every id goes to its owner (slot -1: nothing asked)
    recv = AllToAll.apply(send, group)
    served = []
    for t, s in enumerate(shards):
        want = recv[:, t]  # [m, capacity]: what each model rank asks of this rank's shard
        emb = s[want.clamp(min=0)]
        served.append(torch.where((want >= 0)[..., None], emb, torch.zeros((), dtype=emb.dtype, device=emb.device)))
    # hop 2: the rows go back to the rank that asked
    back = AllToAll.apply(torch.cat(served, dim=2), group)  # [m, capacity, ΣD]
    out, col = [], 0
    for t, s in enumerate(shards):
        rows = back[owners[t], ranks[t], col:col + s.shape[1]]
        out.append(torch.where(kept[t][:, None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device)))
        col += s.shape[1]
    return out, [~k for k in kept]


def all_to_all_lookup(layout: MeshLayout, shards: list, ids: list) -> list:
    """The exact two-hop exchange: ``ids[t]`` are this rank's piece ``[b]``
    (split over both axes) → each table's rows ``[b, D_t]`` for it."""
    return _exchange(layout, shards, ids, ids[0].shape[0])[0]


def capacity_of(b: int, m: int, capacity_factor: float) -> int:
    """Ids a bucket of the capped exchange: ``ceil(b/m · factor)``, at
    least 1 and at most ``b`` (JAX's formula, float for float)."""
    return min(b, max(1, math.ceil(b / m * capacity_factor)))


def capped_all_to_all_lookup(layout: MeshLayout, shards: list, ids: list, capacity_factor: float = 1.25) -> tuple:
    """The skew-bounded two-hop exchange → (each table's rows ``[b, D_t]``,
    zero where dropped; each table's dropped mask ``[b]``)."""
    b = ids[0].shape[0]
    return _exchange(layout, shards, ids, capacity_of(b, layout.model_size, capacity_factor))


def _tables(model: nn.Module) -> list:
    return [model.user_embedding, model.item_embedding, *model.cat_embeddings]


def explicit_x0(model: nn.Module, user_ids: torch.Tensor, item_ids: torch.Tensor, cat_features: torch.Tensor,
                num_features: torch.Tensor, kind: str = "psum", capacity_factor: float = 1.25):
    """The DCN-R input ``x0 [n, d_in]`` of this rank's ``n`` data rows on a
    sharded model (``model.layout``): the row-sharded tables through the
    ``kind`` exchange, the replicated ones gathered locally. For
    ``capped`` → ``(x0, overflow)``, ``overflow = int64[2] = (dropped,
    total)`` id lookups over every row-sharded table and the whole global
    batch (one ``all_reduce`` over every rank), as JAX counts them."""
    if kind not in EXCHANGES:
        raise ValueError(f"unknown exchange kind {kind!r}; expected 'all_to_all', 'psum' or 'capped'")
    layout: MeshLayout = model.layout
    names = table_names(model)
    tables = _tables(model)
    cols = [user_ids, item_ids, *(cat_features[:, i] for i in range(cat_features.shape[1]))]
    sharded = [t for t, name in enumerate(names) if name in layout.sharded]
    parts = [None if t in sharded else tables[t][cols[t]] for t in range(len(tables))]
    dropped = None
    if sharded and kind == "psum":
        for t, rows in zip(sharded, psum_lookup(layout, [tables[t] for t in sharded], [cols[t] for t in sharded])):
            parts[t] = rows
    elif sharded:
        n, m = user_ids.shape[0], layout.model_size
        if n % m:
            raise ValueError(f"the {kind} exchange splits a rank's {n} batch rows over the model axis ({m} ranks): "
                             f"batch_size must divide over data x model")
        b = n // m
        piece = slice(layout.model_rank * b, (layout.model_rank + 1) * b)
        shards, ids = [tables[t] for t in sharded], [cols[t][piece] for t in sharded]
        if kind == "capped":
            rows, masks = capped_all_to_all_lookup(layout, shards, ids, capacity_factor)
            dropped = torch.stack([mk.sum() for mk in masks]).sum()
        else:
            rows = all_to_all_lookup(layout, shards, ids)
        gathered = GatherRows.apply(torch.cat(rows, dim=1), layout.model_group)  # [n, ΣD]: every piece
        for t, g in zip(sharded, gathered.split([r.shape[1] for r in rows], dim=1)):
            parts[t] = g
    x0 = torch.cat([*parts, num_features], dim=1)
    if kind != "capped":
        return x0
    dropped = (torch.zeros(1, dtype=torch.int64, device=x0.device) if dropped is None
               else dropped.reshape(1).clone())
    all_reduce(dropped)
    total = len(sharded) * user_ids.shape[0] * layout.data_size
    return x0, torch.cat([dropped, dropped.new_tensor([total])])
