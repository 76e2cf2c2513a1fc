"""Lazy (sparse-row) embedding-table updates (counterpart of
``hhrs_tpu/train/lazy.py``): a step updates only the table rows its batch
touches, O(B·d) table traffic instead of the dense optimizer's
O(n_rows·d).

A step (:func:`lazy_train_step`):

* gathers the batch's table rows and makes them autograd leaves; x0 is
  their concatenation with the numerical features, and
  ``models/dcn.py::apply_dcn_from_x0`` runs the tower on it (on a card the
  cross kernels; the backward kernel's dx0 carries the rows' gradients);
* the dense optimizer (:class:`LazyTableOptimizer`'s ``dense``) covers the
  non-table parameters only. A table must not be in it: ``AdamW`` decays a
  parameter whose gradient is a zero tensor, so it would decay rows the
  batch never touched;
* each table takes a touched-row Adam/AdamW step (:func:`row_adam_`) at the
  global step count and the dense optimizer's current LR, so a plateau
  decay reaches the tables too.

The rows are made unique without a host sync, so the step can be captured
in a CUDA graph: ``torch.sort``, boundary flags and a ``cumsum`` give each
sorted id its segment, ``index_put_(accumulate=True)`` sums duplicates
into a fixed ``[B]`` buffer (JAX's ``jnp.unique(size=B, fill_value=n)`` +
``segment_sum``) in batch order on the CPU and on a card alike (on a card
its sort-based kernel, where ``index_add_``'s atomics would sum in a
different order each run), and
the pad slots past the last segment write the first segment's new row
again, so their scatter changes nothing.

Semantics, as in the JAX package (and ``torch.optim.SparseAdam``):
moments and weight decay touch only the batch's rows. When every row is
touched every step the update equals the dense ``torch.optim.AdamW(
foreach=True)`` / ``Adam`` bit for bit on the CPU: the row update takes
torch's operations in torch's order (decay ``p·(1 − lr·wd)``, ``lerp`` for
m, ``mul`` + ``addcmul`` for v, ``addcdiv`` with the same bias-correction
expressions), not the JAX formula. With ``capturable`` (a CUDA graph) the
step count and the LR are tensors on the card.

On a training mesh (``parallel/trainer.py::make_lazy_mesh_step``) each rank
runs the step on its ``B/D`` rows; the row step takes the whole global
batch's ids and gradient rows, gathered over the ``data`` axis, and each
model rank steps only the rows of its table shards.
"""

from __future__ import annotations

import torch

from hhrs_tpu_torch.models.dcn import DCNR, apply_dcn_from_x0
from hhrs_tpu_torch.train.metrics import bce_with_logits

B1, B2, EPS = 0.9, 0.999, 1e-8


def table_names(model: DCNR) -> list:
    """The model's embedding tables, by parameter name."""
    return ["user_embedding", "item_embedding"] + [f"cat_embeddings.{i}" for i in range(len(model.cat_embeddings))]


def dense_parameters(model: DCNR) -> list:
    """Every parameter but the embedding tables."""
    tables = set(table_names(model))
    return [p for name, p in model.named_parameters() if name not in tables]


def unique_segments(ids: torch.Tensor, n: int) -> tuple:
    """``jnp.unique(ids, size=B, fill_value=n, return_inverse=True)`` without
    a host sync → ``(uids [B], order [B], seg [B])``: the distinct ids
    ascending then ``n`` in the pad slots, the stable sorting permutation,
    and each sorted position's slot in ``uids``."""
    sorted_ids, order = torch.sort(ids, stable=True)
    new = torch.ones_like(sorted_ids, dtype=torch.bool)
    new[1:] = sorted_ids[1:] != sorted_ids[:-1]
    seg = torch.cumsum(new, 0) - 1
    uids = torch.full_like(sorted_ids, n)
    uids.scatter_(0, seg, sorted_ids)  # equal ids write equal values
    return uids, order, seg


def row_adam_(table: torch.Tensor, m: torch.Tensor, v: torch.Tensor, ids: torch.Tensor, g_rows: torch.Tensor,
              step, lr, wd: float, decoupled: bool) -> None:
    """Touched-row Adam (``decoupled=False``, ``wd·p`` into the gradient) or
    AdamW step of one table, in place. ``step``: the global step count
    after this step (a Python number, or a tensor on the card); ``lr``: a
    Python float, or a tensor on the card."""
    n = table.shape[0]
    uids, order, seg = unique_segments(ids, n)
    g = torch.zeros_like(g_rows).index_put_((seg,), g_rows[order], accumulate=True)  # duplicates, in batch order
    valid = uids < n
    rows = torch.where(valid, uids, uids[0])  # a pad slot reads and writes the first row again
    p_rows, m_rows, v_rows = table[rows], m[rows], v[rows]
    if wd != 0:
        if decoupled:
            p_rows.mul_(1 - lr * wd)
        else:
            g = g.add(p_rows, alpha=wd)
    m_rows.lerp_(g, 1 - B1)
    v_rows.mul_(B2).addcmul_(g, g, value=1 - B2)
    denom = v_rows.sqrt()
    if isinstance(step, torch.Tensor):
        bc1 = 1 - torch.pow(B1, step)
        denom.div_(torch.sqrt(1 - torch.pow(B2, step))).add_(EPS)
        p_rows.addcdiv_(m_rows, denom * (bc1 / -lr))
    else:
        bc1, bc2 = 1 - B1 ** step, 1 - B2 ** step
        denom.div_(bc2 ** 0.5).add_(EPS)
        p_rows.addcdiv_(m_rows, denom, value=(lr / bc1) * -1)
    # pad slots carry the first slot's new values: their writes change nothing
    first = valid[:, None]
    table.index_put_((rows,), torch.where(first, p_rows, p_rows[:1]))
    m.index_put_((rows,), torch.where(first, m_rows, m_rows[:1]))
    v.index_put_((rows,), torch.where(first, v_rows, v_rows[:1]))


class LazyTableOptimizer:
    """The dense optimizer of the non-table parameters plus the tables'
    row-wise moments and the global step count. Stands where a
    ``torch.optim`` optimizer stands in the trainer: ``param_groups`` (the
    dense optimizer's, so a plateau decay reaches both), ``state_dict`` /
    ``load_state_dict`` for checkpoints."""

    def __init__(self, model: DCNR, dense: torch.optim.Optimizer, optimizer: str, weight_decay: float,
                 capturable: bool = False):
        self.model, self.dense = model, dense
        self.names = table_names(model)
        self.decoupled = optimizer.lower() == "adamw"
        self.weight_decay = weight_decay
        params = dict(model.named_parameters())
        self.m = {k: torch.zeros_like(params[k]) for k in self.names}
        self.v = {k: torch.zeros_like(params[k]) for k in self.names}
        dev = params[self.names[0]].device
        self.count = torch.zeros((), dtype=torch.float32, device=dev if capturable else "cpu")
        self.capturable = capturable

    @property
    def param_groups(self) -> list:
        return self.dense.param_groups

    def state_tensors(self) -> list:
        """The moments of both optimizers (the NaN checks read them)."""
        dense = [t for s in self.dense.state.values() for k, t in s.items() if k != "step"]
        return dense + list(self.m.values()) + list(self.v.values())

    def state_dict(self) -> dict:
        return {"dense": self.dense.state_dict(), "m": dict(self.m), "v": dict(self.v), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.dense.load_state_dict(state["dense"])
        for k in self.names:
            self.m[k].copy_(state["m"][k])
            self.v[k].copy_(state["v"][k])
        self.count.copy_(state["count"])

    def step_rows(self, ids: list, g_rows: list, layout=None) -> None:
        """The tables' touched-row step, after the dense optimizer's: one
        more global step, each table's ``ids [n]`` with their gradient rows
        ``[n, D_t]`` (in ``names`` order). On a mesh (``layout``) the ids and
        rows are the whole global batch's; a row-sharded table steps only
        the ids its shard owns, as shard-local rows, in batch order, so its
        rows get the single-device table's sums and no other row is
        written."""
        tables = dict(self.model.named_parameters())
        self.count.add_(1)
        step = self.count if self.capturable else self.count.item()
        lr = self.param_groups[0]["lr"]
        with torch.no_grad():
            for k, i, g in zip(self.names, ids, g_rows):
                if layout is not None and k in layout.sharded:
                    rows = layout.rows(k)
                    mine = (i >= rows.start) & (i < rows.stop)
                    i, g = i[mine] - rows.start, g[mine]
                    if i.numel() == 0:
                        continue
                row_adam_(tables[k].data, self.m[k], self.v[k], i, g, step, lr, self.weight_decay, self.decoupled)


def table_ids(model: DCNR, batch: dict) -> list:
    """The ids of ``batch`` into each table, in :func:`table_names` order."""
    return [batch["user"], batch["item"]] + [batch["cat"][:, i] for i in range(len(model.cat_embeddings))]


def lazy_train_step(model: DCNR, opt: LazyTableOptimizer, batch: dict,
                    generator: torch.Generator | None) -> torch.Tensor:
    """One training step with lazy table updates → the detached loss."""
    tables = dict(model.named_parameters())
    ids = table_ids(model, batch)
    rows = [tables[k].detach()[i].requires_grad_() for k, i in zip(opt.names, ids)]
    x0 = torch.cat([*rows, batch["num"]], dim=1)
    loss = bce_with_logits(apply_dcn_from_x0(model, x0, generator), batch["y"])
    opt.dense.zero_grad(set_to_none=True)
    loss.backward()
    opt.dense.step()
    opt.step_rows(ids, [r.grad for r in rows])
    return loss.detach()
