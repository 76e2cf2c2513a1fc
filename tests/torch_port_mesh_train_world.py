"""What every rank of a CPU gloo world runs for ``tests/test_torch_port_mesh_train.py``.

Kept apart from the test module, which imports JAX: each rank imports only
torch and the port. :func:`mesh_train_checks` runs every check of one mesh
shape in one world, so each shape's world is spawned once, and rank 0
returns the answers (with every rank's summaries) for the tests to compare
with the JAX package's and the port's single-device ones.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os

import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.ops.nn import BatchNorm
from hhrs_tpu_torch.parallel.distributed import init_world
from hhrs_tpu_torch.parallel.embedding import explicit_x0
from hhrs_tpu_torch.parallel.mesh import all_gather, all_reduce, make_mesh
from hhrs_tpu_torch.train.artifacts import export_artifacts
from hhrs_tpu_torch.train.lazy import table_names
from hhrs_tpu_torch.train.trainer import train_dcn

# The runs of every world: (name, train-config changes, exchange, capacity factor).
RUNS = (
    ("default", {}, None, 1.25),
    ("psum", {}, "psum", 1.25),
    ("all_to_all", {}, "all_to_all", 1.25),
    ("capped_m", {}, "capped", None),  # factor m: the exact exchange
    ("capped_1", {}, "capped", 1.0),
    ("resident", {"mesh_resident_data": True}, None, 1.25),
    ("dropout", {"dropout": True}, None, 1.25),
    ("options", {"debug_nans": True, "eval_every": 2, "eval_catalog_recall": True, "moment_dtype": "bfloat16"},
     None, 1.25),
    ("bf16", {"compute_dtype": "bfloat16"}, None, 1.25),
)


def _gathered(t: torch.Tensor, group) -> torch.Tensor:
    return t if group is None else all_gather(t, group).flatten(0, 1)


def _summed(t: torch.Tensor, group) -> torch.Tensor:
    return t if group is None else all_reduce(t.clone(), group)


def _replicated_digest(model) -> str:
    """A digest of every tensor this rank holds whole (all but the table shards)."""
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        if k not in model.layout.sharded:
            h.update(k.encode())
            h.update(v.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _exchange_checks(spec: dict, mesh) -> dict:
    """x0 and the whole tables' gradients of ``sum(x0 · ct)`` over the lookup
    batch through each exchange, and the capped exchange's counts."""
    model = dcnr_from_jax(*spec["init"], spec["dims"], ModelConfig(**spec["mcfg"]), "cpu", train=True, mesh=mesh)
    layout = model.layout
    lk = {k: torch.as_tensor(v) for k, v in spec["lookup"].items()}
    n = lk["user"].shape[0] // layout.data_size
    mine = {k: v[layout.data_rank * n:(layout.data_rank + 1) * n] for k, v in lk.items()}
    params = dict(model.named_parameters())
    out = {}
    M = layout.model_size
    for kind, factor in [("default", None), ("psum", None), ("all_to_all", None),
                         *(("capped", f) for f in (1.0, 1.25, float(M)))]:
        model.zero_grad(set_to_none=True)
        overflow = None
        if kind == "default":
            x0 = model.embed(mine["user"], mine["item"], mine["cat"], mine["num"])
        else:
            x0 = explicit_x0(model, mine["user"], mine["item"], mine["cat"], mine["num"], kind, factor or 1.25)
            if kind == "capped":
                x0, overflow = x0
        (x0 * mine["ct"]).sum().backward()
        grads = {}
        for name in table_names(model):
            g = _summed(params[name].grad, layout.data_group)  # the whole batch's gradient of this rank's rows
            grads[name] = (_gathered(g.contiguous(), layout.model_group) if name in layout.sharded else g).numpy()
        out[(kind, factor)] = {"x0": _gathered(x0.detach(), layout.data_group).numpy(), "grads": grads,
                               "overflow": None if overflow is None else overflow.tolist()}
    return out


def _bn_check(spec: dict, mesh) -> dict:
    """One train-mode step of a BatchNorm synced over ``data`` on this
    rank's rows of ``spec["bn"]``'s batch: the output, the input and
    parameter gradients, the running statistics, all gathered."""
    from hhrs_tpu_torch.parallel.sharding import MeshLayout

    layout = MeshLayout.of(mesh, {})
    x, ct = (torch.as_tensor(spec["bn"][k]) for k in ("x", "ct"))
    n = x.shape[0] // layout.data_size
    rows = slice(layout.data_rank * n, (layout.data_rank + 1) * n)
    bn = BatchNorm(x.shape[1], momentum=0.1).train()
    bn.group = layout.data_group
    xl = x[rows].clone().requires_grad_()
    y = bn(xl)
    (y * ct[rows]).sum().backward()
    return {"y": _gathered(y.detach(), layout.data_group).numpy(),
            "dx": _gathered(xl.grad, layout.data_group).numpy(),
            "dscale": _summed(bn.scale.grad, layout.data_group).numpy(),
            "dbias": _summed(bn.bias.grad, layout.data_group).numpy(),
            "mean": bn.mean.numpy(), "var": bn.var.numpy()}


def _train(spec: dict, mesh, changes: dict, exchange, factor, splits=None, **kw):
    mcfg = dict(spec["mcfg"], dropout=spec["dropout"]) if changes.get("dropout") else dict(spec["mcfg"])
    if "compute_dtype" in changes:
        mcfg["compute_dtype"] = changes["compute_dtype"]
    train_changes = {k: v for k, v in changes.items() if k not in ("dropout", "compute_dtype")}
    tcfg = TrainConfig(**{**spec["tcfg"], **train_changes})
    M = mesh.size(1)
    return train_dcn(splits or spec["splits"], spec["dims"], ModelConfig(**mcfg), tcfg, mesh=mesh,
                     explicit_exchange=exchange,
                     exchange_capacity_factor=float(M) if factor is None else factor, init_state=spec["init"],
                     device="cpu", **kw)


def mesh_train_checks(spec: dict) -> dict | None:
    """Every check at this world's mesh shape; rank 0 → its answers and
    every rank's summaries, None on the other ranks."""
    torch.set_num_threads(1)
    D, M = spec["shape"]
    mesh = make_mesh(D, M, "cpu")
    rank = dist.get_rank()
    out = {"shape": tuple(mesh.shape), "exchange": _exchange_checks(spec, mesh), "bn": _bn_check(spec, mesh)}
    runs, mine = {}, {}
    for name, changes, exchange, factor in RUNS:
        r = _train(spec, mesh, changes, exchange, factor)
        runs[name] = {"history": r.history, "final": r.final_metrics, "params": r.params, "bn_state": r.bn_state}
        mine[name] = {"history": r.history, "replicated": _replicated_digest(r.model),
                      "shards": {k: tuple(r.model.state_dict()[k].shape) for k in r.model.layout.sharded}}
        if name == "default":
            art = os.path.join(spec["tmp"], f"artifact_{D}x{M}")
            export_artifacts(art, r.params, r.bn_state, ModelConfig(**spec["mcfg"]), spec["dims"], spec["preproc"],
                             r.final_metrics)
            out["artifact"] = art
    # checkpoint and resume: 1 epoch saved, then the 3-epoch run resumed from it
    ck = os.path.join(spec["tmp"], f"ck_{D}x{M}")
    first = _train(spec, mesh, {"n_epochs": 1}, None, 1.25, checkpoint_dir=ck)
    resumed = _train(spec, mesh, {}, None, 1.25, checkpoint_dir=ck)
    runs["resumed"] = {"history": resumed.history, "final": resumed.final_metrics, "params": resumed.params,
                       "first": first.history, "files": sorted(os.listdir(ck))}
    # debug_nans: a NaN in one rank's rows of a batch raises on every rank (no rank waits for another)
    num = spec["splits"].train_num.copy()
    num[::97] = float("nan")
    try:
        _train(spec, mesh, {"debug_nans": True, "n_epochs": 1}, None, 1.25,
               splits=dataclasses.replace(spec["splits"], train_num=num))
        mine["nan_raised"] = False
    except FloatingPointError:
        mine["nan_raised"] = True
    out["runs"] = runs
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank != 0:
        return None
    out["ranks"] = every
    return out


@contextlib.contextmanager
def one_rank_world(store_dir: str):
    """A gloo world of this process alone on the CPU, for as long as the
    block runs; ``make_mesh(1, 1, "cpu")`` lays a 1x1 mesh over it."""
    init_world(0, 1, f"file://{os.path.join(store_dir, 'one_rank_store')}", "cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()
