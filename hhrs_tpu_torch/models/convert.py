"""Weight carrier between a JAX ``(params, bn_state)`` tree of numpy arrays
and a :class:`~hhrs_tpu_torch.models.dcn.DCNR`'s parameters and buffers.

The tree may hold lists (the JAX package's in-memory form) or maps keyed
``"0"``, ``"1"``, … (the flax msgpack form); both flatten to the same
dotted paths, which are the module's ``state_dict`` keys. Loading is
strict: a missing, extra or mis-shaped leaf raises. An embedding table may
be an int8 table (an object with ``values`` and ``scales``, as
``quantize_embedding_params`` of either package makes): the model then
holds it as an ``ops/quant.py::QuantizedTable``. :func:`jax_from_dcnr`
goes the other way: BatchNorm ``mean``/``var`` go to ``bn_state``, every
other leaf to ``params``, and lists take the JAX in-memory form.
:func:`two_tower_from_jax` carries the two-tower retriever's params tree
(``hhrs_tpu/retrieval/two_tower.py``'s ``init_two_tower`` layout) into a
:class:`~hhrs_tpu_torch.retrieval.two_tower.TwoTower` the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.ops.quant import QuantizedTable


def flatten_tree(tree, prefix: str = "") -> dict:
    """Nested dicts/lists → ``{"a.0.b": leaf}``."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def dcnr_from_jax(params, bn_state, dims: ModelDims, cfg: ModelConfig,
                  device: str | torch.device = "cpu", train: bool = False) -> DCNR:
    """Build a :class:`DCNR` on ``device`` holding exactly the given JAX
    weights (numpy leaves), in eval mode, or in train mode with ``train``."""
    state = {**flatten_tree(params), **flatten_tree(bn_state)}
    tables = {k: state.pop(k) for k in list(state) if hasattr(state[k], "scales")}
    with torch.device("meta"):
        model = DCNR(dims, cfg)
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()}
    if tables:
        tensors.update(_install_quantized(model, tables))
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.to(device).train(train)


def _install_quantized(model: DCNR, tables: dict) -> dict:
    """Put a QuantizedTable in place of each table parameter named in
    ``tables`` → their buffers as state-dict entries."""
    n_cat = len(model.cat_embeddings)
    cats = [f"cat_embeddings.{i}" for i in range(n_cat)]
    if any(k in tables for k in cats) and not all(k in tables for k in cats):
        raise ValueError("either every categorical table is quantized or none is")
    entries = {}
    q = {k: QuantizedTable(torch.tensor(np.asarray(v.values)), torch.tensor(np.asarray(v.scales)))
         for k, v in tables.items()}
    for name in ("user_embedding", "item_embedding"):
        if name in q:
            delattr(model, name)
            setattr(model, name, q[name])
    if n_cat and cats[0] in q:
        model.cat_embeddings = torch.nn.ModuleList([q[k] for k in cats])
    unknown = set(q) - {"user_embedding", "item_embedding", *cats}
    if unknown:
        raise ValueError(f"only embedding tables may be quantized, got {sorted(unknown)}")
    for k, table in q.items():
        entries.update({f"{k}.{b}": t for b, t in table.state_dict().items()})
    return entries


def jax_from_dcnr(model: DCNR) -> tuple[dict, dict]:
    """A :class:`DCNR`'s weights → ``(params, bn_state)`` numpy trees in the
    JAX layout: the inverse of :func:`dcnr_from_jax`."""
    leaf = lambda t: t.detach().cpu().numpy().copy()  # noqa: E731
    lin = lambda m: {"kernel": leaf(m.kernel), "bias": leaf(m.bias)}  # noqa: E731
    params = {
        "user_embedding": leaf(model.user_embedding),
        "item_embedding": leaf(model.item_embedding),
        "cat_embeddings": [leaf(t) for t in model.cat_embeddings],
    }
    res_state = []
    if model.has_deep:
        params["initial_deep"] = lin(model.initial_deep)
        blocks = []
        for block in model.res_blocks:
            if hasattr(block, "bn1"):
                blocks.append({
                    "layer1": lin(block.layer1),
                    "bn1": {"scale": leaf(block.bn1.scale), "bias": leaf(block.bn1.bias)},
                    "layer2": lin(block.layer2),
                    "bn2": {"scale": leaf(block.bn2.scale), "bias": leaf(block.bn2.bias)},
                })
                res_state.append({
                    "bn1": {"mean": leaf(block.bn1.mean), "var": leaf(block.bn1.var)},
                    "bn2": {"mean": leaf(block.bn2.mean), "var": leaf(block.bn2.var)},
                })
            else:  # dcn_mlp: a plain linear, no state
                blocks.append({"layer": lin(block.layer)})
                res_state.append({})
        params["res_blocks"] = blocks
    if model.has_cross:
        params["cross"] = {"w": leaf(model.cross.w), "b": leaf(model.cross.b)}
    params["final"] = lin(model.final)
    return params, {"res_blocks": res_state}


def two_tower_from_jax(params, dims: ModelDims, cfg, device: str | torch.device = "cpu"):
    """Build a :class:`~hhrs_tpu_torch.retrieval.two_tower.TwoTower` (for a
    ``TwoTowerConfig`` ``cfg``) on ``device`` holding exactly the given JAX
    retriever weights (numpy leaves). Strict: a missing, extra or
    mis-shaped leaf raises."""
    from hhrs_tpu_torch.retrieval.two_tower import TwoTower

    with torch.device("meta"):
        model = TwoTower(dims, cfg)
    tensors = {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flatten_tree(params).items()}
    model.load_state_dict(tensors, strict=True, assign=True)
    return model.to(device)
