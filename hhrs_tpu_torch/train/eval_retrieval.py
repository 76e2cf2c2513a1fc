"""Catalog-ranking recall@k: each evaluated user's val positives against the
whole item catalog (counterpart of ``hhrs_tpu/train/eval_retrieval.py``).

The row-level ``recall_at_k`` (``train/metrics.py``) ranks only a user's
own val rows and reads 1.0 whenever a user has fewer than k of them. This
metric scores every catalog item for each sampled user and asks what share
of the user's held-out positives reach the top k.
:func:`catalog_recall_from_scores` is a copy of the JAX harness (numpy,
scorer-agnostic: the same users, item table, train-seen masking and
denominator); :func:`catalog_recall_at_k` scores with a :class:`DCNR` in
eval mode, as the trainer's ``eval_logits`` does (on a card the cross
forward kernel, not the tower kernel: the JAX function scores with
``apply_dcn``).
"""

from __future__ import annotations

import numpy as np
import torch

from hhrs_tpu_torch.models.dcn import DCNR


def _item_feature_table(splits):
    """``[n_seen]`` item ids and their categorical and numerical features,
    first occurrence wins (train rows, then val rows)."""
    all_item = np.concatenate([splits.train_item, splits.val_item])
    all_cat = np.concatenate([splits.train_cat, splits.val_cat])
    all_num = np.concatenate([splits.train_num, splits.val_num])
    first: dict = {}
    for row, it in enumerate(all_item.tolist()):
        first.setdefault(it, row)
    items = np.fromiter(first.keys(), np.int32)
    rows = np.fromiter(first.values(), np.int64)
    return items, all_cat[rows].astype(np.int32), all_num[rows].astype(np.float32)


def catalog_recall_from_scores(
    score_fn,
    items: np.ndarray,
    splits,
    k: int = 100,
    max_users: int = 512,
    exclude_train: bool = True,
    user_chunk: int = 64,
    seed: int = 0,
) -> float:
    """Mean over users with ≥ 1 val positive of |top-k catalog items ∩ val
    positives| / |val positives|. ``score_fn(user_ids int32 [C]) →
    [C, M]`` scores every catalog item for each user; ``exclude_train``
    masks (and drops from the positives) the items a user rated in the
    train split. NaN when the catalog has no more than k items."""
    M = len(items)
    if M <= k:
        return float("nan")

    val_pos: dict = {}
    for u, it, y in zip(splits.val_user.tolist(), splits.val_item.tolist(),
                        (np.asarray(splits.val_y) > 0.5).tolist()):
        if y:
            val_pos.setdefault(u, set()).add(it)
    users = np.array(sorted(val_pos.keys()), np.int32)
    if len(users) > max_users:
        users = np.random.default_rng(seed).choice(users, max_users, replace=False)

    train_seen: dict = {}
    if exclude_train:
        for u, it in zip(splits.train_user.tolist(), splits.train_item.tolist()):
            train_seen.setdefault(u, set()).add(it)

    item_pos = {int(it): i for i, it in enumerate(items)}

    recalls = []
    for c0 in range(0, len(users), user_chunk):
        chunk = users[c0:c0 + user_chunk]
        scores = np.asarray(score_fn(chunk.astype(np.int32)))[: len(chunk)]
        for ui, u in enumerate(chunk.tolist()):
            s = scores[ui].astype(np.float64)
            pos_items = val_pos[u]
            if exclude_train:
                seen = train_seen.get(u, ())
                for it in seen:
                    pos = item_pos.get(it)
                    if pos is not None:
                        s[pos] = -np.inf
                # a val positive also rated in train is out of the ranking and the target
                pos_items = pos_items - set(seen)
                if not pos_items:
                    continue
            top = np.argpartition(-s, k)[:k]
            top_items = set(items[top].tolist())
            recalls.append(len(pos_items & top_items) / len(pos_items))
    if not recalls:
        return float("nan")
    return float(np.mean(recalls))


@torch.no_grad()
def catalog_recall_at_k(
    model: DCNR,
    splits,
    k: int = 100,
    max_users: int = 512,
    exclude_train: bool = True,
    user_chunk: int = 64,
    seed: int = 0,
) -> float:
    """Catalog recall@k of ``model`` (on its device, put in eval mode):
    each chunk of up to ``user_chunk`` users is one forward pass over
    ``chunk × catalog`` rows."""
    items, x_cat, x_num = _item_feature_table(splits)
    M = len(items)
    dev = next(model.parameters()).device
    d_item = torch.as_tensor(items, dtype=torch.int64, device=dev)
    d_cat = torch.as_tensor(x_cat, dtype=torch.int64, device=dev)
    d_num = torch.as_tensor(x_num, dtype=torch.float32, device=dev)
    model.eval()

    def score_fn(chunk: np.ndarray) -> np.ndarray:
        C = len(chunk)
        users = torch.as_tensor(chunk, dtype=torch.int64, device=dev).repeat_interleave(M)
        logits = model(users, d_item.repeat(C), d_cat.repeat(C, 1), d_num.repeat(C, 1))
        return logits.reshape(C, M).cpu().numpy()

    return catalog_recall_from_scores(score_fn, items, splits, k=k, max_users=max_users,
                                      exclude_train=exclude_train, user_chunk=user_chunk, seed=seed)
