"""The data- and model-parallel train step (counterpart of
``hhrs_tpu/parallel/trainer.py``).

Layout: every rank holds its shards of the row-sharded tables and the
whole of everything else (``parallel/sharding.py``), and trains on its
``B/D`` rows of each batch. A step, with each collective named:

* x0 of the rank's rows through the exchange (``parallel/embedding.py``:
  psum by default, ``all_to_all``, or ``capped``);
* the tower on those rows: BatchNorm synced over the ``data`` axis
  (``ops/nn.py::BatchNorm.group``), dropout masks cut from the global
  batch's, the cross-stack forward and backward kernels on the rank's
  rows;
* the loss of the rank's rows scaled by ``1/D``, so the rank losses sum
  to the global batch's mean; its backward;
* one ``all_reduce`` over the ``data`` axis of one flat bucket holding
  every gradient (the replicated weights', the replicated small tables'
  and this rank's table shards': all of them are summed over exactly the
  ranks with other rows, none over the ``model`` axis, whose ranks hold
  the same rows) and the loss, so every rank gets the global loss;
* AdamW on the rank's tensors: elementwise, so a table shard's update is
  the whole table's update on those rows.

The model axis's ranks compute the same rows and reduce in the same
order, so the replicated weights stay bit-identical on every rank.

With ``train.lazy_table_updates`` (:func:`make_lazy_mesh_step`) the step
differentiates with respect to the gathered rows, as the single-device
lazy step does: the rows come from the psum exchange and become autograd
leaves after it; the gradient bucket holds only the dense parameters and
the loss (no table-sized zeros); one ``all_gather`` over ``data`` of the
ids and one of the row gradients give every rank the global batch's, in
batch order; then each rank takes the touched-row step of its table
shards (``train/lazy.py::LazyTableOptimizer.step_rows``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from hhrs_tpu_torch.parallel.embedding import explicit_x0, psum_lookup
from hhrs_tpu_torch.parallel.mesh import all_gather, all_reduce
from hhrs_tpu_torch.parallel.sharding import MeshLayout, shard_model
from hhrs_tpu_torch.train.lazy import LazyTableOptimizer, dense_parameters, table_ids
from hhrs_tpu_torch.train.metrics import bce_with_logits


@dataclass
class ParallelTrainState:
    model: nn.Module  # this rank's shards of the tables, the rest whole
    opt: torch.optim.Optimizer
    layout: MeshLayout


def sync_batchnorm(model: nn.Module, group) -> None:
    """Point every BatchNorm of ``model`` at ``group`` (None: local statistics)."""
    from hhrs_tpu_torch.ops.nn import BatchNorm

    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


def shard_train_state(mesh, model: nn.Module, make_opt) -> ParallelTrainState:
    """Cut a whole model down to this rank's shards (``shard_model``), sync
    its BatchNorms over the ``data`` axis, and build its optimizer over the
    rank's tensors (``make_opt(model)``): moments live with their parameter."""
    shard_model(model, mesh)
    sync_batchnorm(model, model.layout.data_group)
    return ParallelTrainState(model, make_opt(model), model.layout)


def reduce_gradients(params: list, loss: torch.Tensor, group) -> torch.Tensor:
    """Sum the gradients of ``params`` and the loss over ``group`` in one
    flat bucket (one ``all_reduce``) → the summed loss."""
    if group is None:
        return loss
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    bucket = torch.cat([*(g.reshape(-1) for g in grads), loss.reshape(1).to(grads[0].dtype)])
    all_reduce(bucket, group)
    for p, g in zip(params, bucket[:-1].split([g.numel() for g in grads])):
        p.grad = g.view_as(p)
    return bucket[-1]


def make_parallel_train_step(state: ParallelTrainState, exchange: str | None = None, capacity_factor: float = 1.25):
    """``step(batch, generator)`` on this rank's rows of a batch (``user``,
    ``item``, ``cat``, ``num``, ``y``) → the global batch's detached mean
    loss; with ``exchange="capped"`` → ``(loss, overflow int64[2] =
    (dropped, total))``. ``exchange=None`` is the psum form."""
    model, opt, layout = state.model, state.opt, state.layout
    if isinstance(opt, LazyTableOptimizer):
        return make_lazy_mesh_step(state)
    kind = exchange or "psum"
    params = list(model.parameters())

    def step(batch: dict, generator: torch.Generator | None):
        out = explicit_x0(model, batch["user"], batch["item"], batch["cat"], batch["num"], kind, capacity_factor)
        x0, overflow = out if kind == "capped" else (out, None)
        loss = bce_with_logits(model.tower(x0, generator), batch["y"])
        if layout.data_size > 1:
            loss = loss / layout.data_size
        opt.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_gradients(params, loss.detach(), layout.data_group)
        opt.step()
        return (loss, overflow) if kind == "capped" else loss

    return step


def lazy_rows(layout: MeshLayout, names: list, tables: list, ids: list) -> list:
    """Each table's rows ``[n, D_t]`` of ``ids`` on this rank's data rows, as
    autograd leaves: the row-sharded tables through the psum exchange (one
    ``all_reduce`` over ``model`` for all of them), the replicated ones by a
    local gather."""
    rows = [None if k in layout.sharded else t.detach()[i] for k, t, i in zip(names, tables, ids)]
    sharded = [j for j, k in enumerate(names) if k in layout.sharded]
    if sharded:
        got = psum_lookup(layout, [tables[j].detach() for j in sharded], [ids[j] for j in sharded])
        for j, r in zip(sharded, got):
            rows[j] = r
    return [r.requires_grad_() for r in rows]


def make_lazy_mesh_step(state: ParallelTrainState):
    """``step(batch, generator)`` with lazy table updates on this rank's rows
    of a batch → the global batch's detached mean loss (the psum form;
    ``state.opt`` a ``LazyTableOptimizer``)."""
    model, opt, layout = state.model, state.opt, state.layout
    tables = dict(model.named_parameters())
    dense = dense_parameters(model)
    group = layout.data_group

    def step(batch: dict, generator: torch.Generator | None):
        ids = table_ids(model, batch)
        rows = lazy_rows(layout, opt.names, [tables[k] for k in opt.names], ids)
        loss = bce_with_logits(model.tower(torch.cat([*rows, batch["num"]], dim=1), generator), batch["y"])
        if layout.data_size > 1:
            loss = loss / layout.data_size
        opt.dense.zero_grad(set_to_none=True)
        loss.backward()
        loss = reduce_gradients(dense, loss.detach(), group)
        opt.dense.step()
        ids_all, g_all = torch.stack(ids, dim=1), torch.cat([r.grad for r in rows], dim=1)
        if group is not None:  # the global batch's, in batch order (data rank order)
            ids_all, g_all = all_gather(ids_all, group).flatten(0, 1), all_gather(g_all, group).flatten(0, 1)
        opt.step_rows(list(ids_all.unbind(1)), list(g_all.split([r.shape[1] for r in rows], dim=1)), layout)
        return loss

    return step
