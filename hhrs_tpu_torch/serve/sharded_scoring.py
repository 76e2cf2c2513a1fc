"""Scaled-catalog scoring: the item axis sharded over the mesh.

Counterpart of ``hhrs_tpu/serve/sharded_scoring.py``. Every rank holds its
rows of the catalog (the item axis padded to the shard count with masked
rows) and the whole model, and scores its rows through the engine's route
(``ops/tower.py::score_rows``: the fused tower kernel for f32 ``dcnr``,
else ``DCNR.forward``). ``score_all`` all-gathers the ``[M]`` logits;
``top_k`` reduces each shard to its local top-k first, so one gather moves
only ``[W·k]`` (score, index) pairs — the merge identity of
``retrieval/sharded.py``. Both mesh axes act as one flat shard axis.
"""

from __future__ import annotations

import numpy as np
import torch

from hhrs_tpu_torch.ops.tower import fold_eval_params, score_rows, uses_tower
from hhrs_tpu_torch.parallel.mesh import all_gather, row_shardings
from hhrs_tpu_torch.retrieval.sharded import merge_topk, shard_k
from hhrs_tpu_torch.retrieval.similarity import topk_stable


class ShardedItemScorer:
    """This rank's rows of the catalog (``item_internal [M]``, ``X_cat [M,
    C]``, ``X_num [M, F]``, padded to the mesh size) and a replicated
    model (a ``DCNR`` in eval mode on ``device``)."""

    def __init__(self, mesh, model, item_internal, X_cat, X_num, device: str | torch.device):
        self.mesh = mesh
        self.model = model
        self._folded = fold_eval_params(model) if uses_tower(model.cfg) else None
        self.M = int(np.shape(item_internal)[0])
        self.rows = rows = row_shardings(mesh, self.M)
        pad = rows.padded - self.M

        def local(a, dtype):
            a = np.asarray(a)
            a = np.concatenate([a, np.zeros((pad, *a.shape[1:]), a.dtype)])[rows.start:rows.stop]
            return torch.as_tensor(a, dtype=dtype, device=device)

        self._item = local(item_internal, torch.int64)
        self._cat = local(X_cat, torch.int64)
        self._num = local(X_num, torch.float32)
        self._gidx = torch.arange(rows.start, rows.stop, device=device)
        self._valid = self._gidx < self.M

    @torch.no_grad()
    def _local_logits(self, user_internal: int) -> torch.Tensor:
        users = torch.full_like(self._item, int(user_internal))
        logits = score_rows(self.model, self._folded, users, self._item, self._cat, self._num)
        return torch.where(self._valid, logits, torch.full((), float("-inf"), device=logits.device))

    def score_all(self, user_internal: int) -> torch.Tensor:
        """``[M]`` logits of one user against the whole sharded catalog."""
        return all_gather(self._local_logits(user_internal)).reshape(-1)[: self.M]

    def top_k(self, user_internal: int, k: int) -> tuple[torch.Tensor, torch.Tensor]:
        """(scores, indices) ``[k]`` of the user's global top-k items: a top-k
        per shard, one gather of the pairs, a merge."""
        if k > self.M:
            raise ValueError(f"k={k} > catalog size {self.M}")
        logits = self._local_logits(user_internal)
        vals, pos = topk_stable(logits, shard_k(k, self.rows.padded, self.mesh.size()))
        pairs = all_gather(torch.stack([vals.double(), self._gidx[pos].double()]))  # [W, 2, k_local]
        best, idx = merge_topk(pairs[:, 0, None].float(), pairs[:, 1, None].long(), k)
        return best[0], idx[0]
