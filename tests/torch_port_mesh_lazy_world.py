"""What every rank of a CPU gloo world runs for ``tests/test_torch_port_mesh_lazy.py``.

Kept apart from the test module, which imports JAX: each rank imports only
torch and the port. :func:`mesh_lazy_checks` runs every check of one mesh
shape in one world (lazy table updates and slab streaming over the mesh),
and rank 0 returns the answers with every rank's summaries.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax, flatten_tree
from hhrs_tpu_torch.parallel.mesh import make_mesh
from hhrs_tpu_torch.parallel.trainer import ParallelTrainState, make_parallel_train_step
from hhrs_tpu_torch.train.checkpoint import TrainCheckpointer
from hhrs_tpu_torch.train.lazy import table_ids
from hhrs_tpu_torch.train.trainer import make_train_optimizer, split_tensors, train_dcn
from tests.torch_port_mesh_train_world import _replicated_digest

# The runs of every world: (name, train-config changes, dropout).
RUNS = (
    ("lazy", {"lazy_table_updates": True}, 0.0),
    ("lazy_dropout", {"lazy_table_updates": True}, None),  # None: the spec's dropout
    ("stream", {}, 0.0),
    ("slabs", {"stream_slab_steps": 3}, 0.0),
    ("slabs_resident", {"stream_slab_steps": 3, "mesh_resident_data": True}, 0.0),
)


def _train(spec: dict, mesh, changes: dict, dropout, **kw):
    mcfg = dict(spec["mcfg"], dropout=spec["dropout"] if dropout is None else dropout)
    return train_dcn(spec["splits"], spec["dims"], ModelConfig(**mcfg), TrainConfig(**{**spec["tcfg"], **changes}),
                     mesh=mesh, init_state=spec["init"], device="cpu", **kw)


def checkpoint_arrays(path: str, epoch: int) -> dict:
    """A saved checkpoint's model and optimizer tensors, flattened to numpy
    by dotted key (the dense optimizer's step counts included)."""
    state, _ = TrainCheckpointer(path).restore(epoch, torch.device("cpu"))
    tree = {"model": state["model"], "optimizer": state["optimizer"]}

    def walk(node, prefix):
        if torch.is_tensor(node):
            yield prefix, node.detach().cpu().numpy()
        elif isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, f"{prefix}.{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, f"{prefix}.{i}")

    return dict(walk(tree, ""))


def _shard_step(spec: dict, mesh) -> dict:
    """One lazy mesh step on a batch whose ids into every row-sharded table
    lie in its first half (model shard 0 at m = 2): whether each rank's
    table shards and row moments changed."""
    model = dcnr_from_jax(*spec["init"], spec["dims"], ModelConfig(**spec["mcfg"]), "cpu", train=True, mesh=mesh)
    opt = make_train_optimizer(model, TrainConfig(**{**spec["tcfg"], "lazy_table_updates": True}))
    step = make_parallel_train_step(ParallelTrainState(model, opt, model.layout))
    data = split_tensors(spec["splits"], "train", torch.device("cpu"))
    layout = model.layout
    low = torch.ones_like(data["y"], dtype=torch.bool)
    for k, ids in zip(opt.names, table_ids(model, data)):
        if k in layout.sharded:
            low &= ids < layout.sharded[k] // 2
    rows = torch.nonzero(low).flatten()[:spec["tcfg"]["batch_size"]]
    n = rows.shape[0] // layout.data_size
    mine = rows[layout.data_rank * n:(layout.data_rank + 1) * n]
    tables = {k: p.detach().clone() for k, p in model.named_parameters() if k in opt.names}
    step({k: v[mine] for k, v in data.items()}, None)
    after = dict(model.named_parameters())
    return {"model_rank": layout.model_rank, "rows": int(rows.shape[0]),
            "changed": {k: bool((after[k] != t).any()) for k, t in tables.items() if k in layout.sharded},
            "moments": {k: bool(opt.m[k].any() or opt.v[k].any()) for k in layout.sharded}}


def mesh_lazy_checks(spec: dict) -> dict | None:
    """Every check at this world's mesh shape; rank 0 → its answers and
    every rank's summaries, None on the other ranks."""
    torch.set_num_threads(1)
    D, M = spec["shape"]
    mesh = make_mesh(D, M, "cpu")
    out, mine = {"shape": tuple(mesh.shape)}, {}
    for name, changes, dropout in RUNS:
        r = _train(spec, mesh, changes, dropout)
        out[name] = {"history": r.history, "final": r.final_metrics, "params": flatten_tree(r.params)}
        mine[name] = {"history": r.history, "replicated": _replicated_digest(r.model),
                      "shards": {k: tuple(r.model.state_dict()[k].shape) for k in r.model.layout.sharded}}
    # checkpoint and resume: 1 lazy epoch saved, then the 3-epoch run resumed from it
    ck = os.path.join(spec["tmp"], f"lazy_ck_{D}x{M}")
    first = _train(spec, mesh, {"lazy_table_updates": True, "n_epochs": 1}, 0.0, checkpoint_dir=ck)
    dist.barrier()
    if dist.get_rank() == 0:
        out["checkpoint"] = checkpoint_arrays(ck, 0)
    resumed = _train(spec, mesh, {"lazy_table_updates": True}, 0.0, checkpoint_dir=ck)
    out["resumed"] = {"history": resumed.history, "final": resumed.final_metrics,
                      "params": flatten_tree(resumed.params), "first": first.history}
    mine["shard_step"] = _shard_step(spec, mesh)
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if dist.get_rank() != 0:
        return None
    out["ranks"] = every
    return out

