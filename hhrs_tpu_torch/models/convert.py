"""Weight carrier: a JAX ``(params, bn_state)`` tree of numpy arrays → a
:class:`~hhrs_tpu_torch.models.dcn.DCNR`'s parameters and buffers.

The tree may hold lists (the JAX package's in-memory form) or maps keyed
``"0"``, ``"1"``, … (the flax msgpack form); both flatten to the same
dotted paths, which are the module's ``state_dict`` keys. Loading is
strict: a missing, extra or mis-shaped leaf raises.
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
                  device: str | torch.device = "cpu") -> DCNR:
    """Build a :class:`DCNR` in eval mode on ``device`` holding exactly the
    given JAX weights (numpy leaves)."""
    state = {**flatten_tree(params), **flatten_tree(bn_state)}
    with torch.device("meta"):
        model = DCNR(dims, cfg)
    model.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in state.items()},
        strict=True,
        assign=True,
    )
    return model.to(device).eval()
