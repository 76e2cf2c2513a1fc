"""Two-tower learned retriever (counterpart of
``hhrs_tpu/retrieval/two_tower.py``), a second model family beside the
ranker.

The serve path's candidate expansion reuses the ranker's item table
through a kNN index. The two-tower model trains item vectors for the
retrieval task itself: a user tower and an item tower (small MLPs over
embedding lookups, L2-normalized outputs) trained on the booked positives
(``was_booked == 1``, the ranker's own label) with an in-batch sampled
softmax, one ``[B, B]`` product a step, and the logQ popularity
correction. The item tower reads the item id plus its categorical and
numerical features, so items with few interactions still get vectors.

Opt-in end to end: ``python -m hhrs_tpu_torch.retrieval.two_tower`` trains
and writes ``retrieval_embeddings.npy`` (the artifact's internal item rows,
L2-normalized); the serve engine substitutes it for the ranker's item
table in its similarity surfaces only when given
``retrieval_embeddings`` / ``--retrieval-embeddings``.

Plain PyTorch: the JAX module has no Pallas kernel, and the ``[B, B]``
product is one ``torch.matmul``. Parameter names are the JAX tree's paths
(``user_l1.kernel``, ``cat_embeddings.0``, …), so
``models/convert.py::two_tower_from_jax`` loads a JAX weight tree by name.
Training follows the JAX loop: the positives stay on the device, each
epoch's permutation comes from ``np.random.default_rng(seed)`` (the JAX
run's batches), AdamW with optax's semantics (decay on every parameter,
eps 1e-8), one host sync an epoch.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import statistics
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.ops.nn import Linear, embedding_table
from hhrs_tpu_torch.retrieval.similarity import require_full_f32_matmul
from hhrs_tpu_torch.train.optimizers import make_optimizer

log = logging.getLogger(__name__)

RETRIEVAL_EMB = "retrieval_embeddings.npy"


@dataclass
class TwoTowerConfig:
    emb_dim: int = 32  # id-embedding width (both towers)
    hidden_dim: int = 64  # tower MLP hidden width
    out_dim: int = 32  # shared retrieval space width
    temperature: float = 0.2  # the JAX package's sweep optimum for catalog recall@100
    lr: float = 1e-3
    weight_decay: float = 1e-5
    batch_size: int = 1024  # in-batch negatives: B - 1 per positive
    n_epochs: int = 50
    seed: int = 42


@dataclass
class TwoTowerResult:
    model: "TwoTower"
    history: list = field(default_factory=list)  # [{"epoch": e, "train_loss": mean in-batch loss}]
    final_recall_at_100: float = 0.0
    examples_per_s: float = 0.0  # positives per second, median epoch after the first


def cat_table_width(n: int) -> int:
    """A categorical table's width, ``floor(sqrt(n)) + 1``."""
    return int(math.floor(math.sqrt(n))) + 1


class TwoTower(nn.Module):
    """The two towers' parameters in the JAX tree's layout."""

    def __init__(self, dims: ModelDims, cfg: TwoTowerConfig, generator: torch.Generator | None = None):
        super().__init__()
        self.user_embedding = embedding_table(dims.n_users, cfg.emb_dim, generator)
        self.item_embedding = embedding_table(dims.n_items, cfg.emb_dim, generator)
        self.cat_embeddings = nn.ParameterList(
            [embedding_table(n, cat_table_width(n), generator) for _, n in dims.cat_dims])
        item_in = cfg.emb_dim + sum(cat_table_width(n) for _, n in dims.cat_dims) + dims.n_num_features
        self.user_l1 = Linear(cfg.emb_dim, cfg.hidden_dim, generator)
        self.user_l2 = Linear(cfg.hidden_dim, cfg.out_dim, generator)
        self.item_l1 = Linear(item_in, cfg.hidden_dim, generator)
        self.item_l2 = Linear(cfg.hidden_dim, cfg.out_dim, generator)


def init_two_tower(generator: torch.Generator, dims: ModelDims, cfg: TwoTowerConfig) -> TwoTower:
    """Fresh towers drawn from ``generator`` (on the CPU; move the module):
    tables ~ N(0, 1), linears ~ U(±1/sqrt(fan_in)), as JAX draws them (not
    the same numbers: a JAX init reaches the port through
    ``models/convert.py::two_tower_from_jax``)."""
    return TwoTower(dims, cfg, generator)


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + eps)


def user_tower(model: TwoTower, user_ids: torch.Tensor) -> torch.Tensor:
    """``[B]`` ids → ``[B, out_dim]`` L2-normalized user vectors."""
    h = torch.relu(model.user_l1(model.user_embedding[user_ids]))
    return _l2norm(model.user_l2(h))


def item_tower(model: TwoTower, item_ids: torch.Tensor, cat: torch.Tensor, num: torch.Tensor) -> torch.Tensor:
    """``[M]`` ids, ``[M, C]`` categorical codes, ``[M, F]`` numericals →
    ``[M, out_dim]`` L2-normalized item vectors."""
    parts = [model.item_embedding[item_ids]]
    parts += [tab[cat[:, i]] for i, tab in enumerate(model.cat_embeddings)]
    parts.append(num)
    h = torch.relu(model.item_l1(torch.cat(parts, dim=1)))
    return _l2norm(model.item_l2(h))


def in_batch_softmax_loss(model: TwoTower, batch: dict, temperature: float,
                          log_q: torch.Tensor | None = None) -> torch.Tensor:
    """In-batch sampled softmax: each positive pair's item against the other
    B - 1 items of the batch, one ``[B, B]`` product. ``log_q`` (``[n_items]``
    log sampling frequency) is subtracted per column (the logQ correction:
    in-batch negatives are drawn by popularity). A duplicate of the row's
    item elsewhere in the batch is a false negative, masked to -inf off the
    diagonal. → the mean over rows of -log softmax of the diagonal."""
    u = user_tower(model, batch["user"])
    v = item_tower(model, batch["item"], batch["cat"], batch["num"])
    logits = (u @ v.T) / temperature
    if log_q is not None:
        logits = logits - log_q[batch["item"]][None, :]
    same = batch["item"][:, None] == batch["item"][None, :]
    eye = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    logits = torch.where(same & ~eye, torch.full((), -math.inf, device=logits.device), logits)
    return -torch.log_softmax(logits, dim=1).diagonal().mean()


def positives(splits) -> tuple[np.ndarray, int]:
    """The train rows labelled booked, and their count."""
    pos = np.asarray(splits.train_y) == 1.0
    return pos, int(pos.sum())


def log_q_table(splits, n_items: int) -> np.ndarray:
    """``[n_items]`` f32 log of each item's share of the positives (+1e-9),
    as the JAX trainer computes it."""
    pos, n_pos = positives(splits)
    counts = np.bincount(np.asarray(splits.train_item)[pos], minlength=n_items).astype(np.float32)
    return np.log(counts / n_pos + 1e-9)


def train_two_tower(splits, dims: ModelDims, cfg: TwoTowerConfig, eval_recall: bool = True,
                    device: str | torch.device | None = None, init: TwoTower | None = None) -> TwoTowerResult:
    """Train on the booked positives → :class:`TwoTowerResult` (the model on
    ``device``, per-epoch mean loss, recall@100 when ``eval_recall``).
    ``device`` defaults to ``cuda`` (raises without a card); ``init`` starts
    from given towers (a copy is trained) instead of a draw from
    ``cfg.seed``."""
    dev = resolve_device(device)
    require_full_f32_matmul(dev)
    pos, n_pos = positives(splits)
    B = min(cfg.batch_size, n_pos)
    if B < 2:
        raise ValueError(f"need >=2 positive rows to form in-batch negatives, got {n_pos}")
    data = {
        "user": torch.as_tensor(np.asarray(splits.train_user)[pos], dtype=torch.int64, device=dev),
        "item": torch.as_tensor(np.asarray(splits.train_item)[pos], dtype=torch.int64, device=dev),
        "cat": torch.as_tensor(np.asarray(splits.train_cat)[pos], dtype=torch.int64, device=dev),
        "num": torch.as_tensor(np.asarray(splits.train_num)[pos], dtype=torch.float32, device=dev),
    }
    if init is None:
        model = init_two_tower(torch.Generator().manual_seed(cfg.seed), dims, cfg)
    else:
        model = TwoTower(dims, cfg)
        model.load_state_dict(init.state_dict())
    model = model.to(dev)
    opt = make_optimizer("adamw", model.parameters(), cfg.lr, cfg.weight_decay)
    log_q = torch.as_tensor(log_q_table(splits, dims.n_items), device=dev)

    steps = max(n_pos // B, 1)
    perm_len = steps * B
    result = TwoTowerResult(model=model)
    shuffle = np.random.default_rng(cfg.seed)
    epoch_times = []
    for epoch in range(cfg.n_epochs):
        t0 = time.perf_counter()
        perm = shuffle.permutation(n_pos)
        if perm_len > n_pos:
            perm = np.resize(perm, perm_len)
        perm = torch.as_tensor(perm[:perm_len], dtype=torch.int64, device=dev)  # one upload an epoch
        losses = []
        for s in range(steps):
            idx = perm[s * B:(s + 1) * B]
            loss = in_batch_softmax_loss(model, {k: v[idx] for k, v in data.items()}, cfg.temperature, log_q)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        mean_loss = float(torch.stack(losses).mean())  # the epoch's one host sync
        result.history.append({"epoch": epoch, "train_loss": mean_loss})
        log.info("two-tower epoch %d: in-batch softmax loss %.4f", epoch, mean_loss)
        if epoch > 0:
            epoch_times.append(time.perf_counter() - t0)
    if epoch_times:
        result.examples_per_s = steps * B / max(statistics.median(epoch_times), 1e-9)
    if eval_recall:
        result.final_recall_at_100 = catalog_recall(model, splits, k=100)
    return result


@torch.no_grad()
def item_vectors(model: TwoTower, item_ids, cat, num) -> torch.Tensor:
    """Item vectors of host arrays, on the model's device."""
    dev = model.item_embedding.device
    return item_tower(model, torch.as_tensor(np.asarray(item_ids), dtype=torch.int64, device=dev),
                      torch.as_tensor(np.asarray(cat), dtype=torch.int64, device=dev),
                      torch.as_tensor(np.asarray(num), dtype=torch.float32, device=dev))


def catalog_recall(model: TwoTower, splits, k: int = 100, max_users: int = 512) -> float:
    """Retrieval recall@k through the ranker's scorer-agnostic harness
    (``train/eval_retrieval.py``): user vectors against every catalog
    item's, the product on the host as JAX takes it."""
    from hhrs_tpu_torch.train.eval_retrieval import _item_feature_table, catalog_recall_from_scores

    items, cat_tab, num_tab = _item_feature_table(splits)
    V = item_vectors(model, items, cat_tab, num_tab).cpu().numpy()
    dev = model.user_embedding.device

    @torch.no_grad()
    def score_fn(user_chunk: np.ndarray) -> np.ndarray:
        U = user_tower(model, torch.as_tensor(user_chunk, dtype=torch.int64, device=dev)).cpu().numpy()
        return U @ V.T

    return catalog_recall_from_scores(score_fn, items, splits, k=k, max_users=max_users)


def export_retrieval_embeddings(out_dir: str, model: TwoTower, splits, dims: ModelDims) -> str:
    """Write ``retrieval_embeddings.npy``: one L2-normalized f32 vector per
    internal item id (the ranker artifact's ``item_embeddings`` rows, which
    the engine substitutes one for one). Items never seen in the splits get
    their id-only vector (features zero). → the file's path."""
    from hhrs_tpu_torch.train.eval_retrieval import _item_feature_table

    items, cat_tab, num_tab = _item_feature_table(splits)
    n_cat = cat_tab.shape[1] if cat_tab.ndim == 2 else len(dims.cat_dims)
    full_cat = np.zeros((dims.n_items, n_cat), np.int32)
    full_num = np.zeros((dims.n_items, dims.n_num_features), np.float32)
    full_cat[items] = cat_tab
    full_num[items] = num_tab
    V = item_vectors(model, np.arange(dims.n_items), full_cat, full_num).cpu().numpy().astype(np.float32)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, RETRIEVAL_EMB)
    np.save(path, V)
    return path


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description="Train the two-tower retriever with the PyTorch port")
    p.add_argument("--data", default="data")
    p.add_argument("--out", default="artifacts")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synth-users", type=int, default=2000)
    p.add_argument("--synth-items", type=int, default=500)
    p.add_argument("--synth-reviews", type=int, default=40000)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--emb-dim", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default; raises without a card) or cpu")
    return p


def main(argv=None) -> int:
    """Train the retriever and export its vectors::

        python -m hhrs_tpu_torch.retrieval.two_tower [--synthetic] --data DIR --out DIR \\
            [--epochs N] [--batch-size B] [--emb-dim D] [--device cuda|cpu]
    """
    from hhrs_tpu_torch.config import build_config
    from hhrs_tpu_torch.train.cli import build_dataset, ensure_synthetic
    from hhrs_tpu_torch.utils.logging import setup_logging

    setup_logging()
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg_all = build_config([], log=log)
    ensure_synthetic(args, cfg_all)
    splits, art = build_dataset(args.data, cfg_all)
    dims = ModelDims.from_artifacts(art)

    cfg = TwoTowerConfig()
    if args.epochs is not None:
        cfg = dataclasses.replace(cfg, n_epochs=args.epochs)
    if args.batch_size is not None:
        cfg = dataclasses.replace(cfg, batch_size=args.batch_size)
    if args.emb_dim is not None:
        cfg = dataclasses.replace(cfg, emb_dim=args.emb_dim)

    r = train_two_tower(splits, dims, cfg, device=device)
    log.info("two-tower catalog recall@100: %.4f (throughput %.0f ex/s on %s)",
             r.final_recall_at_100, r.examples_per_s, device)
    path = export_retrieval_embeddings(args.out, r.model, splits, dims)
    log.info("retrieval embeddings exported to %s (serve with --retrieval-embeddings %s)", path, path)
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
