"""Per-rank feeding and the gathered state of a training mesh (counterpart
of ``hhrs_tpu/parallel/multiprocess.py``).

Every rank holds the same host splits and computes the same shuffled
permutation from the shared seed; what it uploads is only its own rows:
the rows of each batch that its ``data`` coordinate owns
(:func:`epoch_rows`, the counterpart of ``put_global`` under
``P(None, "data")``), and its share of the val split when that divides
over the ``data`` axis (:func:`val_rows`). The counterpart of
``replicated_host``, the whole weight tree on every rank, is
``models/convert.py::jax_from_dcnr`` of a sharded model (every rank joins
the gather).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["is_multiprocess", "epoch_rows", "val_rows", "host_rows"]


def is_multiprocess() -> bool:
    """True in a ``torch.distributed`` world of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def epoch_rows(perm: np.ndarray, steps: int, batch_size: int, layout) -> np.ndarray:
    """``[steps, B/D]``: the train rows of each of an epoch's batches
    (``perm[s·B:(s+1)·B]``) that this rank's data coordinate owns."""
    n = batch_size // layout.data_size
    start = layout.data_rank * n
    return perm[:steps * batch_size].reshape(steps, batch_size)[:, start:start + n]


def val_rows(n_val: int, layout) -> slice:
    """This rank's rows of the val split: its share over the ``data`` axis
    when ``n_val`` divides over it, else all of them (replicated, as JAX
    replicates a ragged val set)."""
    if n_val % layout.data_size:
        return slice(None)
    per = n_val // layout.data_size
    return slice(layout.data_rank * per, (layout.data_rank + 1) * per)


def host_rows(splits, prefix: str, rows, dtypes: dict, device: torch.device) -> dict:
    """The ``rows`` (an index array or a slice) of one split's arrays as
    tensors on ``device``: only these rows leave the host."""
    return {name: torch.as_tensor(np.asarray(getattr(splits, f"{prefix}_{name}")[rows]), dtype=dtype, device=device)
            for name, dtype in dtypes.items()}
