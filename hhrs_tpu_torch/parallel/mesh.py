"""Device mesh, row layouts and the collectives of mesh serving.

Counterpart of ``hhrs_tpu/parallel/mesh.py``. The JAX package is single
controller: one process sees every device and XLA inserts the collectives.
Here each mesh position is a process of a ``torch.distributed`` world
(``parallel/distributed.py``), each holding plain local tensors (its rows
of every sharded axis), and the collectives are written out below — no
DTensor, so every collective that runs is named in the code.

Two logical axes, as in JAX: ``data`` and ``model``. Serving uses both
flat: rank ``r`` of the mesh (row-major over ``(data, model)``, which is
JAX's ``P(("data", "model"))`` order) holds shard ``r`` of every row-sharded
axis, padded to equal shards (:func:`pad_to_shards`). Training uses them
apart: :func:`axis_group` is the process group of this rank's ``data`` axis
(the ranks that share its model coordinate: batch rows split over them,
gradients and BatchNorm statistics summed over them) or of its ``model``
axis (the ranks that share its data coordinate: table rows split over
them, the embedding exchange runs among them).

The collectives below each take their group explicitly. The differentiable
ones (:class:`AllReduceSum`, :class:`ReplicatedSum`, :class:`GatherRows`,
:class:`AllToAll`) say in their names what their backward does, since that
depends on whether the ranks downstream hold different rows (a sum of
their gradients) or the same rows (no sum: each already holds the whole
gradient).

Transport: the backend's own. NCCL takes CUDA tensors (and its
collectives can be captured in a CUDA graph); gloo takes CPU tensors, and
CUDA tensors too (ranks that share one card), which it copies through the
host itself.
"""

from __future__ import annotations

import logging
import re
from typing import NamedTuple

import torch
import torch.distributed as dist

from hhrs_tpu_torch.device import resolve_device

log = logging.getLogger(__name__)

AXIS_NAMES = ("data", "model")


def mesh_shape_for(n_devices: int, model_axis: int | None = None) -> tuple[int, int]:
    """Pick a (data, model) grid for ``n_devices``: the model axis gets the
    largest power-of-two divisor of ``n_devices`` that is at most the
    requested size (default 2 from 4 devices up, else 1), data the rest."""
    if model_axis is None:
        model_axis = 2 if n_devices >= 4 else 1
    m = 1
    while m * 2 <= model_axis and n_devices % (m * 2) == 0:
        m *= 2
    return n_devices // m, m


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """A CLI ``--mesh`` spec — ``DATA`` or ``DATAxMODEL`` (``2``, ``4x2``) —
    → ``(data, model)``; ``ValueError`` with the JAX CLI's text otherwise."""
    m = re.fullmatch(r"(\d+)(?:[xX](\d+))?", spec.strip())
    if not m or int(m.group(1)) < 1 or int(m.group(2) or 1) < 1:
        raise ValueError(f"--mesh must be DATA or DATAxMODEL (e.g. 4x2), got {spec!r}")
    return int(m.group(1)), int(m.group(2) or 1)


def make_mesh(n_data: int = -1, n_model: int = 1, device: str | torch.device | None = None):
    """A ``DeviceMesh`` with dims ``("data", "model")`` over the initialized
    world, ranks laid out row-major (``n_data=-1``: every rank not on the
    model axis). The mesh must cover the world: a rank outside it would
    have no shard to serve. ``device`` is ``cuda`` by default (raising
    without a card; the CPU only when asked). Its current device must
    already be set (``distributed.init_world`` does), so the mesh never
    picks one itself; the check below holds it to that."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed world (parallel/distributed.py)")
    n = dist.get_world_size()
    if n_model < 1 or (n_data < 1 and n_data != -1):
        raise ValueError(f"mesh axes must be >= 1, got {n_data}x{n_model}")
    if n_data == -1:
        if n % n_model != 0:
            raise ValueError(f"{n} devices not divisible by model axis {n_model}")
        n_data = n // n_model
    if n_data * n_model > n:
        raise ValueError(f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, have {n}")
    if n_data * n_model < n:
        raise ValueError(f"mesh {n_data}x{n_model} covers {n_data * n_model} of the world's {n} ranks")
    device = resolve_device(device)
    before = torch.cuda.current_device() if device.type == "cuda" else None
    mesh = DeviceMesh(device.type, torch.arange(n).reshape(n_data, n_model), mesh_dim_names=AXIS_NAMES)
    if device.type == "cuda" and torch.cuda.current_device() != before:
        raise RuntimeError(f"DeviceMesh moved rank {dist.get_rank()} from cuda:{before} to "
                           f"cuda:{torch.cuda.current_device()}")
    return mesh


def mesh_from_spec(spec: str, device: str | torch.device | None = None):
    """:func:`parse_mesh_spec`, then :func:`make_mesh` over the world."""
    return make_mesh(*parse_mesh_spec(spec), device=device)


def mesh_size(mesh) -> int:
    """Ranks of the mesh (1 without one)."""
    return int(mesh.size()) if mesh is not None else 1


def shard_index(mesh) -> int:
    """This rank's shard: its mesh coordinate, row-major over the dims."""
    if mesh is None:
        return 0
    idx = 0
    for size, c in zip(mesh.shape, mesh.get_coordinate()):
        idx = idx * size + c
    return idx


def pad_to_shards(n: int, mesh) -> int:
    """Smallest multiple of the mesh's size that is ``>= n`` (``n`` itself
    without a mesh). The caller decides what the pad rows hold."""
    m = mesh_size(mesh)
    return -(-n // m) * m


class RowLayout(NamedTuple):
    """Shard ``shard`` of an axis of ``n`` rows padded to ``padded``: rows
    ``[start, stop)``, ``padded // shards`` of them."""

    n: int
    padded: int
    start: int
    stop: int

    @property
    def rows(self) -> int:
        return self.stop - self.start


def row_layout(n: int, shards: int, shard: int) -> RowLayout:
    """The row layout of shard ``shard`` of ``shards`` over an axis of ``n``
    rows (the counterpart of ``row_shardings``' ``P(axes)``)."""
    padded = -(-n // shards) * shards
    per = padded // shards
    return RowLayout(n, padded, shard * per, (shard + 1) * per)


def row_shardings(mesh, n: int) -> RowLayout:
    """This rank's :func:`row_layout` of an ``n``-row axis over ``mesh``."""
    return row_layout(n, mesh_size(mesh), shard_index(mesh))


# ---- the axes of a training mesh --------------------------------------------- #


def axis_size(mesh, axis: str) -> int:
    """Ranks along ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else int(mesh.size(AXIS_NAMES.index(axis)))


def axis_rank(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else int(mesh.get_coordinate()[AXIS_NAMES.index(axis)])


def axis_group(mesh, axis: str):
    """The process group of this rank's ``axis``: its ranks in the order of
    their coordinate along it (the group rank is that coordinate)."""
    group = mesh.get_group(axis)
    if dist.get_group_rank(group, dist.get_rank()) != axis_rank(mesh, axis):
        raise RuntimeError(f"the {axis} group's rank order is not the mesh's {axis} coordinate")
    return group


# ---- collectives, each on an explicit group (None: every rank) ------------ #


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[W, *t.shape]``: every group rank's ``t`` (at least 1-D), in group
    rank order."""
    t = t.contiguous()
    W = dist.get_world_size(group)
    out = torch.empty((W * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t, group=group)
    return out.view(W, *t.shape)


def broadcast_object(obj, device: torch.device | None = None, src: int = 0):
    """Rank ``src``'s picklable ``obj`` on every rank of the world
    (``broadcast_object_list`` through ``device``, the backend's wire: the
    card on NCCL, the host on gloo); the other ranks pass anything."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=device)
    return box[0]


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced in place over ``group`` (``op``, a sum by default) → ``t``."""
    dist.all_reduce(t, op=op, group=group)
    return t


def all_to_all_single(t: torch.Tensor, group=None) -> torch.Tensor:
    """``[W, ...]`` → ``[W, ...]``: slice ``j`` of dim 0 goes to group rank
    ``j``; slice ``i`` of the result came from group rank ``i``."""
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


class AllReduceSum(torch.autograd.Function):
    """``Σ_group t``, where each rank's loss downstream is its own term of
    one sum (rows split over the group): the backward sums the gradients
    over the group too (sync BatchNorm's statistics)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class ReplicatedSum(torch.autograd.Function):
    """``Σ_group t``, where every rank of the group then computes the same
    loss on the result (rows replicated over the group): each rank already
    holds the whole gradient, so the backward passes it on unsummed (the
    psum exchange over the ``model`` axis)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class GatherRows(torch.autograd.Function):
    """``[W·n, ...]``: every group rank's ``[n, ...]`` rows, in group rank
    order, where every rank then computes the same loss on them: the
    backward keeps this rank's rows of the gradient, unsummed (the
    all_to_all exchange's pieces reassembled over the ``model`` axis)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.n = group, t.shape[0]
        return all_gather(t, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        r = dist.get_group_rank(ctx.group, dist.get_rank()) if ctx.group is not None else dist.get_rank()
        return g[r * ctx.n:(r + 1) * ctx.n], None


class AllToAll(torch.autograd.Function):
    """:func:`all_to_all_single` under autograd: its transpose is itself, so
    the backward sends each gradient slice back to the rank it came from."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_to_all_single(t, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_single(g, ctx.group), None
