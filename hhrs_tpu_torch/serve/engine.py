"""Two-stage recommendation engine: retrieval → DCN-R ranking → MMR.

Counterpart of ``hhrs_tpu/serve/engine.py::RecommendationEngine`` on
PyTorch. Request-independent state (candidate masks and the kNN table,
the serve-item feature matrix, normalized item embeddings, the model) is
built once on the engine's device. A batch of K requests then runs as
tensor work with a leading batch dimension — the JAX engine's ``vmap`` —
and ends in ONE device→host copy of a packed ``order | mmr | count``
int64 vector per request; the host only translates ids and assembles JSON.

Ranking covers only the request city's item rows by default (exact:
candidates are a subset of the city's items by construction); with
``city_bounded=False`` every serve item is ranked. ``dcnr`` artifacts are
scored by the fused tower kernel (``ops/tower.py::tower_eval``); the other
architectures by ``DCNR.forward``. Edge semantics match the reference:
unknown user → model id ``n_users // 2``; no candidates → a message
response; λ = 1.0 returns the full sorted candidate list, λ < 1 the MMR
top-20.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from hhrs_tpu_torch.config import RetrievalConfig, round_up
from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_friendships_csv, load_reviews_csv
from hhrs_tpu_torch.data.preprocess import encode_item_features
from hhrs_tpu_torch.data.table import first_occurrence, isna, take
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.ops.mmr import NEG_INF, mmr_rerank
from hhrs_tpu_torch.ops.tower import build_x0, fold_eval_params, tower_eval
from hhrs_tpu_torch.retrieval.candidates import CandidateGenerator, ServeUniverse
from hhrs_tpu_torch.retrieval.graph import FriendGraph
from hhrs_tpu_torch.retrieval.similarity import cosine_topk, normalize_rows, require_full_f32_matmul
from hhrs_tpu_torch.train.artifacts import ArtifactBundle, load_artifact_bundle

log = logging.getLogger(__name__)

# Serve options of the JAX engine that this port does not have yet, with
# the ROADMAP item that brings each.
_NOT_PORTED = {
    "bf16": "ROADMAP A5b (bf16 serving)",
    "quantize_tables": "ROADMAP A5b (int8 tables, ops/quant.py::QuantizedTable)",
    "candidate_cap": "ROADMAP A5b (candidate-cap path, engine._rank_capped)",
    "mesh": "ROADMAP A11 (multi-device serving)",
    "retrieval_embeddings_path": "ROADMAP A10 (two-tower retriever)",
}


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"unexpected option {name!r}")
        if value:
            raise NotImplementedError(f"{name} is not ported yet: {_NOT_PORTED[name]}")


def default_device() -> torch.device:
    """``cuda`` when a card is present; otherwise raise — the port never
    carries on quietly on the CPU. Pass ``device="cpu"`` to ask for it."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the engine on the CPU"
        )
    return torch.device("cuda")


class RecommendationEngine:
    def __init__(
        self,
        bundle: ArtifactBundle,
        main: dict,
        friendships: dict,
        retrieval_cfg: RetrievalConfig | None = None,
        *,
        device: str | torch.device,
        city_bounded: bool = True,
        **options,
    ):
        _reject_unported(options)
        self.device = dev = torch.device(device)
        require_full_f32_matmul(dev)
        self.bundle = bundle
        self.retrieval_cfg = retrieval_cfg or RetrievalConfig()
        art = bundle.preproc

        uni = ServeUniverse.from_table(main)
        self.graph = FriendGraph.from_pairs(friendships, uni.user_index)
        self.gen = CandidateGenerator(
            main, art.item_id_mapping, bundle.item_embeddings, self.retrieval_cfg,
            max_sources=max(256, round_up(self.graph.max_degree, 64)),
            universe=uni, device=dev,
        )

        # Serve-item feature matrix: the first row of each item, in
        # serve-index order (the reference's drop_duplicates ranking frame).
        items = take(main, first_occurrence(main[schema.ITEM_COL]))
        _, x_cat, x_num = encode_item_features(art, items)
        item_internal = self.gen.s2t_np  # unknown → 0 (fallback parity)
        emb_serve = torch.as_tensor(bundle.item_embeddings[item_internal], dtype=torch.float32)
        self._dev = {
            "item_internal": torch.as_tensor(item_internal, dtype=torch.int64, device=dev),
            "x_cat": torch.as_tensor(x_cat, dtype=torch.int64, device=dev),
            "x_num": torch.as_tensor(x_num, dtype=torch.float32, device=dev),
            "embedded": torch.as_tensor(self.gen.s2t_valid_np, device=dev),
            "emb_norm": normalize_rows(emb_serve.to(dev)),
        }
        emb_train = torch.as_tensor(bundle.item_embeddings, dtype=torch.float32, device=dev)
        self._emb_train = emb_train
        self._table_norm_train = normalize_rows(emb_train)
        self._reverse_item_map = {v: k for k, v in art.item_id_mapping.items()}

        cfg = bundle.model_cfg
        self.model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, cfg, dev)
        self._variant = cfg.cross_variant
        if cfg.arch == "dcnr":
            self._folded = fold_eval_params(self.model)
            log.info("arch dcnr: scoring through the fused tower kernel (ops/tower.py)")
        else:
            self._folded = None
            log.info("arch %s: scoring through DCNR.forward", cfg.arch)

        # recommended_by source: positive review rows in table order, users
        # deduplicated per item with their first-appearance order kept.
        pos = main["rating_overall"].astype(np.float64) >= 8
        self._pos_users_by_item: dict = {}
        seen_by_item: dict = {}
        for it, u in zip(main[schema.ITEM_COL][pos].tolist(), main[schema.USER_COL][pos].tolist()):
            seen = seen_by_item.setdefault(it, set())
            if u not in seen:
                seen.add(u)
                self._pos_users_by_item.setdefault(it, []).append(u)

        self._payload_city = items["city"]
        self._payload_price = items["price_rub"].astype(np.float64)
        self._payload_stars = items["stars"].astype(np.float64)
        self._unknown_user = art.unknown_user_id
        self._user_map = art.user_id_mapping

        W = int(self.gen.city_rows_np.shape[1])
        self._city_bounded = bool(city_bounded and W < self.gen.M)
        self._order_width = W if self._city_bounded else self.gen.M
        self._all_rows = torch.arange(self.gen.M, dtype=torch.int64, device=dev)

    # ------------------------------------------------------------------ #

    def _logits(self, users, items, x_cat, x_num) -> torch.Tensor:
        if self._folded is not None:
            x0 = build_x0(self.model, users, items, x_cat, x_num)
            return tower_eval(self._folded, x0, self._variant)
        return self.model(users, items, x_cat, x_num)

    @torch.no_grad()
    def _rank_rows(self, cand, count, user_internal, lam, idx) -> torch.Tensor:
        """Ranking + MMR restricted to the rows ``idx`` ``[K, W]`` (ascending
        serve indices, padded with M). Exact when every candidate is in
        ``idx``: the request city's rows, or all M rows (``_rank_full``).
        Returns the packed ``[K, W + top_k + 1]`` int64 output; stable
        tie-breaks follow row position == ascending serve index."""
        M = self.gen.M
        K, W = idx.shape
        d = self._dev
        safe = torch.clamp(idx, max=M - 1)
        valid = (idx < M) & torch.gather(cand, 1, safe)
        flat = safe.reshape(-1)
        users = user_internal[:, None].expand(K, W).reshape(-1)
        logits = self._logits(users, d["item_internal"][flat], d["x_cat"][flat], d["x_num"][flat])
        scores = torch.where(valid, logits.reshape(K, W), torch.full((), NEG_INF, device=idx.device))
        mmr = mmr_rerank(
            scores, d["emb_norm"][safe], valid, d["embedded"][safe] & valid, lam,
            top_k=self.retrieval_cfg.mmr_top_k,
        )
        order = torch.gather(idx, 1, torch.argsort(-scores, dim=1, stable=True))
        mmr_idx = torch.where(mmr >= 0, torch.gather(idx, 1, torch.clamp(mmr, min=0)), -1)
        return torch.cat([order, mmr_idx, count[:, None]], dim=1)

    def _rank_full(self, cand, count, user_internal, lam) -> torch.Tensor:
        """Every serve item ranked (``city_bounded=False``)."""
        idx = self._all_rows.expand(cand.shape[0], -1)
        return self._rank_rows(cand, count, user_internal, lam, idx)

    # ------------------------------------------------------------------ #

    def _host_inputs(self, user_id: int, city: str, mode: str):
        return (
            self.gen.sources_for(user_id, mode, self.graph),
            self.gen.city_index(city),
            self._user_map.get(user_id, self._unknown_user),
        )

    def _assemble(self, user_id: int, lambda_param: float, packed: np.ndarray) -> dict:
        W = self._order_width
        order, mmr_idx, count = packed[:W], packed[W:-1], int(packed[-1])
        if count == 0:
            return {"ranked_hotels": [], "message": "No suitable candidates found."}
        ranked = mmr_idx[mmr_idx >= 0] if lambda_param < 1.0 else order[:count]
        ranked_ext = self.gen.universe.item_ids[ranked]
        friends = set(self.graph.friends_of(user_id).tolist())
        return {
            "ranked_hotels": [
                self._hotel_payload(int(si), int(ext), friends) for si, ext in zip(ranked, ranked_ext)
            ]
        }

    def _hotel_payload(self, serve_idx: int, ext_id: int, friends: set) -> dict:
        recommended_by = []
        if friends:
            recommended_by = [
                int(u) for u in self._pos_users_by_item.get(ext_id, ()) if u in friends
            ]
        city = self._payload_city[serve_idx]
        price = float(self._payload_price[serve_idx])
        stars = float(self._payload_stars[serve_idx])
        return {
            "hotel_id": ext_id,
            "city": None if isna(city) else str(city),
            "price_rub": None if isna(price) else price,
            "stars": None if isna(stars) else stars,
            "recommended_by": recommended_by,
        }

    def recommend(self, user_id: int, city: str, mode: str = "friends",
                  lambda_param: float = 0.7) -> dict:
        return self.recommend_many([(user_id, city, mode, lambda_param)])[0]

    def recommend_many(self, requests: list) -> list:
        """``[(user_id, city, mode, lambda_param), …]`` → responses. The batch
        runs as one set of launches with K leading, and one device→host copy."""
        K = len(requests)
        if K == 0:
            return []
        sources = np.empty((K, self.gen.max_sources), np.int64)
        city_i = np.empty(K, np.int64)
        user_i = np.empty(K, np.int64)
        lam = np.empty(K, np.float32)
        for k, (u, c, mode, l) in enumerate(requests):
            sources[k], city_i[k], user_i[k] = self._host_inputs(u, c, mode)
            lam[k] = l
        dev = self.device
        sources_t = torch.from_numpy(sources).to(dev)
        city_t = torch.from_numpy(city_i).to(dev)
        user_t = torch.from_numpy(user_i).to(dev)
        lam_t = torch.from_numpy(lam).to(dev)
        cand, _neg, count = self.gen.generate_batch(sources_t, city_t)
        if self._city_bounded:
            rows = self.gen.dev["city_rows"][torch.clamp(city_t, max=len(self.gen.universe.cities))]
            packed = self._rank_rows(cand, count, user_t, lam_t, rows)
        else:
            packed = self._rank_full(cand, count, user_t, lam_t)
        packed = packed.cpu().numpy()  # the one device→host copy
        return [self._assemble(u, l, packed[k]) for k, (u, _c, _m, l) in enumerate(requests)]

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def similar_items(self, item_id: int, n: int = 10) -> list | None:
        """Top-n similar items; None if the item is unknown."""
        internal = self.bundle.preproc.item_id_mapping.get(item_id)
        if internal is None:
            return None
        _, idx = cosine_topk(self._table_norm_train, self._emb_train[internal][None, :], n + 1)
        neighbours = idx[0, 1:].cpu().tolist()  # drop the first hit (self)
        return [int(self._reverse_item_map[t]) for t in neighbours if t in self._reverse_item_map]

    def warmup(self) -> None:
        """Run one request of each kind before traffic (builds the kernel)."""
        uni = self.gen.universe
        if uni.n_users and uni.cities:
            u, c = int(uni.user_ids[0]), uni.cities[0]
            self.recommend(u, c, "friends", 0.7)
            self.recommend_many([(u, c, "personal", 1.0), (u, c, "friends", 0.7)])

    @classmethod
    def from_dirs(cls, artifacts_dir: str, data_dir: str, retrieval_cfg=None,
                  device: str | torch.device | None = None, city_bounded: bool = True,
                  **options) -> "RecommendationEngine":
        """Load an artifact directory and the serve CSVs
        (``hackathon_augmented_data.csv``, ``friendships.csv``) from
        ``data_dir``. ``device`` defaults to ``cuda`` and raises without one."""
        _reject_unported(options)
        device = default_device() if device is None else torch.device(device)
        bundle = load_artifact_bundle(artifacts_dir)
        main = add_engineered_features(
            load_reviews_csv(os.path.join(data_dir, "hackathon_augmented_data.csv"))
        )
        friendships = load_friendships_csv(os.path.join(data_dir, "friendships.csv"))
        return cls(bundle, main, friendships, retrieval_cfg, device=device,
                   city_bounded=city_bounded, **options)
