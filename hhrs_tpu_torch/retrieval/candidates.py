"""Hybrid candidate generation as fixed-shape masked tensor work.

Counterpart of ``hhrs_tpu/retrieval/candidates.py`` (single device). The
semantics are the reference's:

  1. source reviews = friends' rows (mode ``friends``) or the user's own rows
     (mode ``personal``) over the unfiltered serve table;
  2. positives = items those sources rated >= 8; negatives = items rated <= 4;
  3. each positive with a trained embedding is expanded with its 10 nearest
     cosine neighbours (drop-first-hit);
  4. if fewer than 20 candidates so far — counting "ghost" neighbours, train
     items absent from the serve table — the top-100 rows of the target city
     by ``user_reviews_count`` are unioned in;
  5. intersect with the target city's items, subtract negatives.

Requests carry a leading batch dimension ``K``. Every scatter is an integer
``index_add_`` followed by ``> 0``: exact and deterministic on CUDA, where a
plain assignment with duplicate indices is not.

With ``mesh`` (``parallel/mesh.py``), the counterpart of the JAX
generator's sharded state: the item axis pads to the mesh size (``Mp``,
pad rows never candidates) and each rank holds only its slice — its rows
of the review arrays, of ``s2t_valid`` and of the kNN and ghost tables,
its columns of the city masks. A batch then takes three collectives: one
``all_reduce(MAX)`` of the positive and negative masks scattered from the
rank's review rows, one of the kNN and ghost expansion from its kNN rows,
and the candidate count by ``all_reduce(SUM)``; the fallback and the city
intersection run on the rank's own columns. ``generate_batch`` returns the
rank's columns of the masks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import RetrievalConfig, round_up
from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import map_fill, unique_first
from hhrs_tpu_torch.parallel.mesh import all_gather, row_shardings
from hhrs_tpu_torch.retrieval.similarity import build_neighbor_table


@dataclass
class ServeUniverse:
    """Host-side vocabularies of the serve table (unfiltered CSV)."""

    item_ids: np.ndarray  # [M] external ids, order of first appearance
    user_ids: np.ndarray  # [U] external ids
    cities: list  # [C] city names, order of first appearance
    item_index: dict  # ext item -> 0..M-1
    user_index: dict  # ext user -> 0..U-1
    city_index: dict  # name -> 0..C-1

    @property
    def n_items(self) -> int:
        return len(self.item_ids)

    @property
    def n_users(self) -> int:
        return len(self.user_ids)

    @classmethod
    def from_table(cls, main: dict) -> "ServeUniverse":
        item_ids = unique_first(main[schema.ITEM_COL])
        user_ids = unique_first(main[schema.USER_COL])
        cities = unique_first(main["city"], dropna=True).tolist()
        try:
            item_index = {int(v): i for i, v in enumerate(item_ids.tolist())}
            user_index = {int(v): i for i, v in enumerate(user_ids.tolist())}
        except (TypeError, ValueError) as e:
            raise ValueError(
                "serve data contains non-integral user/item ids "
                f"({e}); the REST contract types ids as integers"
            ) from e
        return cls(
            item_ids=item_ids,
            user_ids=user_ids,
            cities=cities,
            item_index=item_index,
            user_index=user_index,
            city_index={c: i for i, c in enumerate(cities)},
        )


def _any_into(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``out[k, j] = any(values[k, i] for i with index[i] == j)`` → [K, n]."""
    counts = torch.zeros(values.shape[0], n, dtype=torch.int32, device=values.device)
    return counts.index_add_(1, index, values.to(torch.int32)) > 0


class CandidateGenerator:
    """Builds the per-item masks and tables once on ``device`` (under
    ``mesh``, this rank's slice of them); answers batches of requests with
    fixed-shape tensor work."""

    def __init__(
        self,
        main: dict,
        item_id_mapping: dict,  # train vocab: ext item -> train internal id
        item_embeddings: np.ndarray,  # [n_train, emb]
        cfg: RetrievalConfig | None = None,
        max_sources: int = 256,
        universe: ServeUniverse | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        self.cfg = cfg or RetrievalConfig()
        self.mesh = mesh
        self.universe = uni = universe if universe is not None else ServeUniverse.from_table(main)
        self.device = torch.device(device)
        M, U, C = uni.n_items, uni.n_users, len(uni.cities)
        self.max_sources = max_sources
        self.M, self.U = M, U

        # --- review arrays (length R) ---
        r_user = map_fill(main[schema.USER_COL], uni.user_index, -1).astype(np.int64)
        r_item = map_fill(main[schema.ITEM_COL], uni.item_index, -1).astype(np.int64)
        r_rating = main["rating_overall"].astype(np.float32)

        # --- serve item -> train internal id (+validity) ---
        s2t = np.zeros(M, np.int32)
        s2t_valid = np.zeros(M, bool)
        for ext, si in uni.item_index.items():
            ti = item_id_mapping.get(ext)
            if ti is not None:
                s2t[si] = ti
                s2t_valid[si] = True
        self.s2t_np = s2t
        self.s2t_valid_np = s2t_valid

        # --- kNN expansion table in serve-item space: [M, expand]; M = dump ---
        E = self.cfg.expand_neighbors
        n_train = item_embeddings.shape[0]
        nbr_train = build_neighbor_table(
            torch.as_tensor(np.asarray(item_embeddings, np.float32), device=self.device), E
        )
        reverse = {v: k for k, v in item_id_mapping.items()}
        t2s = np.full(n_train + 1, M, np.int32)  # slot n_train: the tiny-catalog pad
        # Ghost neighbours: train items absent from the serve table. They can
        # never be candidates, but the reference counts them toward the
        # <min_candidates check, so each gets one slot of its own.
        t2ghost = np.full(n_train + 1, 0, np.int32)
        n_ghosts = 0
        for ti in range(n_train):
            ext = reverse.get(ti)
            if ext is not None and ext in uni.item_index:
                t2s[ti] = uni.item_index[ext]
            else:
                t2ghost[ti] = n_ghosts
                n_ghosts += 1
        self.n_ghosts = G = n_ghosts
        t2ghost = np.where(t2s == M, t2ghost, G)
        t2ghost[n_train] = G
        nbr_by_serve = np.full((M, E), M, np.int32)
        nbr_by_serve[s2t_valid] = t2s[nbr_train][s2t[s2t_valid]]
        ghost_by_serve = np.full((M, E), G, np.int32)
        ghost_by_serve[s2t_valid] = t2ghost[nbr_train][s2t[s2t_valid]]
        self.nbr_by_serve_np = nbr_by_serve

        # --- per-city masks: membership (row C = unknown city, empty) and the
        #     popularity pool (stable sorts keep table order on ties) ---
        city_item = np.zeros((C + 1, M), bool)
        city_pop = np.zeros((C + 1, M), bool)
        counts = main["user_reviews_count"].astype(np.float64)
        city_codes = map_fill(main["city"], uni.city_index, C).astype(np.int32)
        city_item[city_codes, r_item] = True
        city_item[C] = False
        row_order = np.argsort(city_codes, kind="stable")
        bounds = np.searchsorted(city_codes[row_order], np.arange(C + 1))
        for c in range(C):
            rows = row_order[bounds[c]: bounds[c + 1]]
            top = rows[np.argsort(-counts[rows], kind="stable")[: self.cfg.popular_pool]]
            city_pop[c, r_item[top]] = True

        # --- per-city item rows (ascending serve indices, M-padded), width
        #     W = max city size rounded up to 64: the city-bounded ranking ---
        cc, items_in_city = np.nonzero(city_item)
        city_counts = np.bincount(cc, minlength=C + 1)
        maxc = int(city_counts.max()) if city_counts.size else 0
        W = min(M, max(64, round_up(maxc, 64)))
        city_rows = np.full((C + 1, W), M, np.int64)
        starts = np.concatenate([[0], np.cumsum(city_counts)[:-1]])
        city_rows[cc, np.arange(len(cc)) - starts[cc]] = items_in_city
        self.city_rows_np = city_rows

        # --- this rank's slice: item rows [start, stop) of the Mp-padded
        #     axis (the dump slot moves from M to Mp) and review rows of the
        #     R-padded axis (pad rows select no user's positives or negatives)
        self.items = items = row_shardings(mesh, M)
        self.Mp = Mp = items.padded
        reviews = row_shardings(mesh, len(r_user))
        nbr = np.where(nbr_by_serve == M, Mp, nbr_by_serve)
        nbr = np.concatenate([nbr, np.full((Mp - M, E), Mp, np.int32)])
        ghost_nbr = np.concatenate([ghost_by_serve, np.full((Mp - M, E), G, np.int32)])
        r_pad = reviews.padded - len(r_user)
        rows = slice(reviews.start, reviews.stop)
        cols = slice(items.start, items.stop)
        pad_r = lambda a: np.concatenate([a, np.zeros(r_pad, a.dtype)])[rows]  # noqa: E731
        pad_c = lambda a: np.pad(a, ((0, 0), (0, Mp - M)))[:, cols]  # noqa: E731

        t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt, device=self.device)  # noqa: E731
        self.dev = {
            "r_user": t(pad_r(r_user), torch.int64),
            "r_item": t(pad_r(r_item), torch.int64),
            "r_pos": t(pad_r(r_rating >= 8.0), torch.bool),
            "r_neg": t(pad_r(r_rating <= 4.0), torch.bool),
            "s2t_valid": t(np.pad(s2t_valid, (0, Mp - M))[cols], torch.bool),
            "nbr": t(nbr[cols].reshape(-1), torch.int64),
            "ghost_nbr": t(ghost_nbr[cols].reshape(-1), torch.int64),
            "city_item": t(pad_c(city_item), torch.bool),
            "city_pop": t(pad_c(city_pop), torch.bool),
        }
        if mesh is None:  # the city-bounded ranking (single device only)
            self.dev["city_rows"] = t(city_rows, torch.int64)

    def _any_over_ranks(self, mask: torch.Tensor) -> torch.Tensor:
        """Under a mesh, the OR of every rank's ``mask`` (``all_reduce(MAX)``)."""
        if self.mesh is None:
            return mask
        mask = mask.to(torch.uint8)
        dist.all_reduce(mask, dist.ReduceOp.MAX)
        return mask.bool()

    def generate_batch(self, sources: torch.Tensor, city_idx: torch.Tensor):
        """sources ``[K, S]`` serve-user indices (dump = U); city_idx ``[K]``
        (C = unknown city). Returns (cand ``[K, Mp/W]``, neg ``[K, Mp/W]``,
        count ``[K]``): this rank's columns of the masks (all M of them
        without a mesh) and the whole batch's candidate counts."""
        dev, Mp, U, G = self.dev, self.Mp, self.U, self.n_ghosts
        E = self.cfg.expand_neighbors
        cols = slice(self.items.start, self.items.stop)
        K = sources.shape[0]
        user_mask = torch.zeros(K, U + 1, dtype=torch.bool, device=sources.device)
        user_mask = user_mask.scatter_(1, sources, True)[:, :U]
        row_sel = user_mask[:, dev["r_user"]]  # [K, R/W]
        pos_neg = torch.stack([_any_into(Mp, dev["r_item"], row_sel & dev["r_pos"]),
                               _any_into(Mp, dev["r_item"], row_sel & dev["r_neg"])])
        pos_mask, neg_mask = self._any_over_ranks(pos_neg)  # [K, Mp] each

        contrib = (pos_mask[:, cols] & dev["s2t_valid"]).repeat_interleave(E, dim=1)  # [K, Mp/W*E]
        reach = torch.cat([_any_into(Mp + 1, dev["nbr"], contrib)[:, :Mp],
                           _any_into(G + 1, dev["ghost_nbr"], contrib)[:, :G]], dim=1)
        reach = self._any_over_ranks(reach)
        cand = pos_mask | reach[:, :Mp]
        count_before = cand.sum(dim=1) + reach[:, Mp:].sum(dim=1)
        fallback = (count_before < self.cfg.min_candidates)[:, None] & dev["city_pop"][city_idx]
        cand = (cand[:, cols] | fallback) & dev["city_item"][city_idx] & ~neg_mask[:, cols]
        count = cand.sum(dim=1)
        if self.mesh is not None:
            dist.all_reduce(count)
        return cand, neg_mask[:, cols], count

    def sources_for(self, user_id: int, mode: str, friend_graph) -> np.ndarray:
        """Host-side source selection → padded serve-user index vector."""
        if mode == "friends":
            return friend_graph.padded_friend_indices(user_id, self.max_sources, dump=self.U)
        out = np.full(self.max_sources, self.U, np.int32)
        own = self.universe.user_index.get(int(user_id))
        if own is not None:
            out[0] = own
        return out

    def city_index(self, city) -> int:
        return self.universe.city_index.get(city, len(self.universe.cities))

    def generate(self, user_id: int, city: str, mode: str, friend_graph) -> tuple:
        """One request → (cand mask ``[M]`` numpy bool, count int). Under a
        mesh every rank calls it, and the columns are gathered."""
        src = torch.as_tensor(
            self.sources_for(user_id, mode, friend_graph)[None], dtype=torch.int64, device=self.device
        )
        cidx = torch.tensor([self.city_index(city)], dtype=torch.int64, device=self.device)
        cand, _neg, count = self.generate_batch(src, cidx)
        if self.mesh is not None:
            cand = all_gather(cand).permute(1, 0, 2).reshape(1, self.Mp)[:, : self.M]
        return cand[0].cpu().numpy(), int(count[0])
