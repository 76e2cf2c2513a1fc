"""Weight carrier between a JAX ``(params, bn_state)`` tree of numpy arrays
and a :class:`~hhrs_tpu_torch.models.dcn.DCNR`'s parameters and buffers.

The tree may hold lists (the JAX package's in-memory form) or maps keyed
``"0"``, ``"1"``, … (the flax msgpack form); both flatten to the same
dotted paths, which are the module's ``state_dict`` keys. Loading is
strict: a missing, extra or mis-shaped leaf raises. :func:`jax_from_dcnr`
goes the other way: BatchNorm ``mean``/``var`` go to ``bn_state``, every
other leaf to ``params``, and lists take the JAX in-memory form.
"""

from __future__ import annotations

import numpy as np
import torch

from hhrs_tpu_torch.config import ModelConfig
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims


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
    with torch.device("meta"):
        model = DCNR(dims, cfg)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()},
        strict=True,
        assign=True,
    )
    return model.to(device).train(train)


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
