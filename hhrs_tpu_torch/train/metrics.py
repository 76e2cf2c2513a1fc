"""Evaluation metrics: BCE-with-logits, ROC AUC, RMSE, per-user recall@k.

Counterpart of ``hhrs_tpu/train/metrics.py``. :func:`bce_with_logits` works
on tensors (the training loss and the val loss); the others are copies of
the JAX package's numpy metrics, run on the host over the final logits.
AUC is the Mann-Whitney statistic with tie-averaged ranks, equal to
sklearn's ``roc_auc_score`` for binary labels.
"""

from __future__ import annotations

import numpy as np
import torch


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy on logits, in the JAX package's stable
    form ``max(l, 0) − l·y + log1p(exp(−|l|))``."""
    per_ex = torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    return per_ex.mean()


def auc_score(labels: np.ndarray, scores: np.ndarray) -> float:
    """Mann-Whitney AUC with tie-averaged ranks (== sklearn roc_auc_score)."""
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    sorted_scores = scores[order]
    n = len(sorted_scores)
    starts = np.flatnonzero(np.concatenate([[True], sorted_scores[1:] != sorted_scores[:-1]]))
    ends = np.append(starts[1:], n)  # exclusive
    avg = (starts + 1 + ends) / 2.0  # mean of ranks start+1 .. end
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = np.repeat(avg, ends - starts)
    sum_pos_ranks = ranks[labels > 0.5].sum()
    return float((sum_pos_ranks - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def rmse_of_probs(labels: np.ndarray, logits: np.ndarray) -> float:
    probs = 1.0 / (1.0 + np.exp(-np.asarray(logits, dtype=np.float64)))
    return float(np.sqrt(np.mean((np.asarray(labels) - probs) ** 2)))


def recall_at_k(user_ids: np.ndarray, labels: np.ndarray, scores: np.ndarray, k: int = 100) -> float:
    """Per-user recall@k averaged over users with ≥1 positive: the share
    of a user's positives that rank in that user's top-k by score."""
    user_ids = np.asarray(user_ids)
    labels = np.asarray(labels) > 0.5
    scores = np.asarray(scores, dtype=np.float64)

    order = np.lexsort((-scores, user_ids))  # group by user, scores desc
    u_sorted = user_ids[order]
    l_sorted = labels[order]
    starts = np.r_[0, np.flatnonzero(u_sorted[1:] != u_sorted[:-1]) + 1]
    group_of = np.cumsum(np.isin(np.arange(len(u_sorted)), starts)) - 1
    rank_in_group = np.arange(len(u_sorted)) - starts[group_of]

    hits = l_sorted & (rank_in_group < k)
    pos_per_group = np.zeros(len(starts))
    hit_per_group = np.zeros(len(starts))
    np.add.at(pos_per_group, group_of, l_sorted)
    np.add.at(hit_per_group, group_of, hits)
    valid = pos_per_group > 0
    if not valid.any():
        return float("nan")
    return float(np.mean(hit_per_group[valid] / pos_per_group[valid]))
