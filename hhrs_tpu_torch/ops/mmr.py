"""Maximal Marginal Relevance reranking over a batch of requests.

Counterpart of ``hhrs_tpu/ops/mmr.py::mmr_rerank`` with an explicit leading
batch dimension ``K`` in place of ``vmap``. Reference semantics:

* the top-scored candidate is picked first, unconditionally;
* each later pick maximizes ``λ·relevance − (1−λ)·max_cos_sim`` to the picks
  so far; only items with a trained embedding count toward the similarity,
  and only they are selectable after the first pick;
* ties go to the item that comes first in descending stable relevance
  order (not to the lowest index);
* selection stops at ``min(top_k, n_candidates)``; unused slots are −1.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def mmr_rerank(
    scores: torch.Tensor,  # [K, M] relevance; NEG_INF for non-candidates
    emb_norm: torch.Tensor,  # [K, M, d] L2-normalized embeddings (junk where not embedded)
    cand_mask: torch.Tensor,  # [K, M] bool
    embedded: torch.Tensor,  # [K, M] bool: item has a trained embedding
    lambda_param: torch.Tensor,  # [K] float32
    top_k: int = 20,
) -> torch.Tensor:
    """Returns ``[K, top_k]`` int64 picked positions along M, −1 padded."""
    K, M = scores.shape
    dev = scores.device
    rows = torch.arange(K, device=dev)
    lam = lambda_param.to(scores.dtype)[:, None]
    n_cand = cand_mask.sum(dim=1)
    n_select = torch.clamp(n_cand, max=top_k)
    have_any = n_cand > 0

    masked = torch.where(cand_mask, scores, torch.full_like(scores, NEG_INF))
    first = torch.argmax(masked, dim=1)  # first maximum, like jnp.argmax
    order = torch.argsort(-masked, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(M, device=dev).expand(K, M).contiguous()
    )

    selected = torch.zeros(K, M, dtype=torch.bool, device=dev)
    selected[rows, first] = have_any
    out = torch.full((K, top_k), -1, dtype=torch.int64, device=dev)
    out[:, 0] = torch.where(have_any, first, -1)

    def sim_to(j: torch.Tensor) -> torch.Tensor:  # [K, M] cosine to item j of each row
        return torch.bmm(emb_norm, emb_norm[rows, j][:, :, None])[:, :, 0]

    zeros = torch.zeros_like(scores)
    max_sim = torch.where((have_any & embedded[rows, first])[:, None], sim_to(first), zeros)
    no_rank = torch.full_like(rank, M + 1)
    for t in range(1, top_k):
        selectable = cand_mask & ~selected & embedded
        mmr = lam * scores - (1.0 - lam) * max_sim
        mmr = torch.where(selectable, mmr, torch.full_like(mmr, NEG_INF))
        best = mmr.max(dim=1, keepdim=True).values
        j = torch.argmin(torch.where(mmr == best, rank, no_rank), dim=1)
        ok = (t < n_select) & selectable.any(dim=1)
        out[:, t] = torch.where(ok, j, -1)
        selected[rows, j] |= ok
        max_sim = torch.where(ok[:, None], torch.maximum(max_sim, sim_to(j)), max_sim)
    return out
