"""Where the DCN-R state lives on a training mesh (counterpart of
``hhrs_tpu/parallel/sharding.py``).

The embedding tables (``user_embedding``, ``item_embedding``, each of
``cat_embeddings``) are the only state worth splitting: each is
row-sharded over the ``model`` axis when its rows divide it, and
replicated otherwise (a 6-row vocabulary gains nothing from sharding; the
rule of ``param_shardings``). Everything else (the deep tower, the cross
stack, the head, the BatchNorm state) is replicated. An optimizer moment
lives where its parameter lives.

Here a rank holds plain tensors: shard ``j`` of a row-sharded table is
rows ``[j·R/m, (j+1)·R/m)`` on the ranks of model coordinate ``j``.
:func:`shard_model` cuts a whole :class:`~hhrs_tpu_torch.models.dcn.DCNR`
down to this rank's shards (and gives it its :class:`MeshLayout`);
:func:`gathered_state_dict` and :func:`gathered_optimizer_state` put the
whole state back together on every rank (every rank joins the gathers),
and :func:`sharded_state_dict` / :func:`sharded_optimizer_state` take this
rank's slice of a whole one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from hhrs_tpu_torch.parallel.mesh import all_gather, axis_group, axis_rank, axis_size
from hhrs_tpu_torch.train.lazy import table_names

TABLE_KEYS = ("user_embedding", "item_embedding", "cat_embeddings")


def is_table(name: str) -> bool:
    """Whether a state-dict key or JAX tree path (dotted) names an embedding table."""
    return name.split(".")[0] in TABLE_KEYS


def table_is_sharded(rows: int, model_size: int) -> bool:
    """The rule: row-sharded over a model axis of more than one rank when
    the rows divide it, else replicated."""
    return model_size > 1 and rows % model_size == 0


def param_shardings(flat_params: dict, model_size: int) -> dict:
    """``{dotted path: "model" | None}`` for a flat tree of arrays: the
    axis each leaf's rows are split over (``param_shardings``' specs)."""
    return {k: "model" if is_table(k) and v.ndim == 2 and table_is_sharded(v.shape[0], model_size) else None
            for k, v in flat_params.items()}


@dataclass
class MeshLayout:
    """A model's place on a training mesh: the mesh, its two axis groups
    (None where the axis has one rank: nothing to reduce), this rank's
    coordinates, and the row-sharded tables as ``{name: whole rows}``."""

    mesh: object
    data_size: int
    data_rank: int
    model_size: int
    model_rank: int
    data_group: object
    model_group: object
    sharded: dict

    @classmethod
    def of(cls, mesh, sharded: dict) -> "MeshLayout":
        D, M = axis_size(mesh, "data"), axis_size(mesh, "model")
        return cls(mesh, D, axis_rank(mesh, "data"), M, axis_rank(mesh, "model"),
                   axis_group(mesh, "data") if D > 1 else None, axis_group(mesh, "model") if M > 1 else None,
                   dict(sharded))

    def rows(self, name: str) -> slice:
        """This rank's rows of the whole table ``name`` (all of them when it is replicated)."""
        if name not in self.sharded:
            return slice(None)
        per = self.sharded[name] // self.model_size
        return slice(self.model_rank * per, (self.model_rank + 1) * per)

    def batch_rows(self, n: int) -> tuple[int, int]:
        """``(start, total)`` of this rank's ``n`` rows in the global batch
        of ``n·data_size`` rows (split over ``data``)."""
        return self.data_rank * n, n * self.data_size


def _table_owner(model: nn.Module, name: str) -> tuple:
    head, _, idx = name.partition(".")
    return (model.cat_embeddings, int(idx)) if idx else (model, head)


def shard_model(model: nn.Module, mesh) -> nn.Module:
    """Cut a whole DCNR (float tables) down to this rank's table shards, in
    place, and give it its :class:`MeshLayout` (``model.layout``) → the
    model. Every rank must hold the same whole model first."""
    M = axis_size(mesh, "model")
    sharded = {}
    for name in table_names(model):
        owner, key = _table_owner(model, name)
        table = owner[key] if isinstance(key, int) else getattr(owner, key)
        if table_is_sharded(table.shape[0], M):
            sharded[name] = table.shape[0]
    layout = MeshLayout.of(mesh, sharded)
    for name in sharded:
        owner, key = _table_owner(model, name)
        table = owner[key] if isinstance(key, int) else getattr(owner, key)
        shard = nn.Parameter(table.detach()[layout.rows(name)].clone(), requires_grad=table.requires_grad)
        if isinstance(key, int):
            owner[key] = shard
        else:
            setattr(owner, key, shard)
    model.layout = layout
    return model


def gathered_state_dict(model: nn.Module, state: dict | None = None) -> dict:
    """The whole state dict of a sharded model (``state``: one of its
    state dicts, its current one by default), every row-sharded table
    gathered over the ``model`` axis; every rank joins and gets it."""
    state = model.state_dict() if state is None else state
    layout = model.layout
    return {k: (all_gather(v.contiguous(), layout.model_group).flatten(0, 1) if k in layout.sharded else v)
            for k, v in state.items()}


def sharded_state_dict(model: nn.Module, whole: dict) -> dict:
    """This rank's slice of a whole state dict, for ``model.load_state_dict``."""
    layout = model.layout
    return {k: (v[layout.rows(k)].clone() if k in layout.sharded else v) for k, v in whole.items()}


def _table_params(model: nn.Module, opt) -> dict:
    """``{optimizer param index: table name}`` of the row-sharded tables."""
    names = {id(p): n for n, p in model.named_parameters()}
    order = [p for group in opt.param_groups for p in group["params"]]
    return {i: names[id(p)] for i, p in enumerate(order) if names.get(id(p)) in model.layout.sharded}


def gathered_optimizer_state(model: nn.Module, opt) -> dict:
    """``opt.state_dict()`` with each row-sharded table's moments gathered
    over the ``model`` axis: the single-device optimizer's state dict.
    Every rank joins and gets it."""
    sd = opt.state_dict()
    layout = model.layout
    for i, name in _table_params(model, opt).items():
        shard_rows = layout.sharded[name] // layout.model_size
        sd["state"][i] = {k: (all_gather(v.contiguous(), layout.model_group).flatten(0, 1)
                              if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == shard_rows else v)
                          for k, v in sd["state"].get(i, {}).items()}
    return sd


def sharded_optimizer_state(model: nn.Module, opt, whole: dict) -> dict:
    """This rank's slice of a whole optimizer state dict, for
    ``opt.load_state_dict``."""
    layout = model.layout
    state = dict(whole["state"])
    for i, name in _table_params(model, opt).items():
        rows = layout.sharded[name]
        state[i] = {k: (v[layout.rows(name)].clone()
                        if torch.is_tensor(v) and v.dim() > 0 and v.shape[0] == rows else v)
                    for k, v in state.get(i, {}).items()}
    return {**whole, "state": state}
