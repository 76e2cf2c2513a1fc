"""Two-stage recommendation engine: retrieval → DCN-R ranking → MMR.

Counterpart of ``hhrs_tpu/serve/engine.py::RecommendationEngine`` on
PyTorch. Request-independent state (candidate masks and the kNN table,
the serve-item feature matrix, normalized item embeddings, the model) is
built once on the engine's device. A batch of K requests is padded to a
bucket of Kp rows (a power of two, or ``pad_to``; pad rows copy the last
request), goes to the device in one upload of a packed ``sources | city |
user | λ`` int32 matrix, runs as tensor work with a leading batch
dimension — the JAX engine's ``vmap`` — and ends in ONE device→host copy of
a packed ``order | mmr | count`` int64 vector per request; the host only
translates ids and assembles JSON for the K real requests.

On a card every bucket runs as a CUDA graph, the counterpart of the JAX
engine's ``jit``: captured at the bucket's first request (or by
``warmup(batch_pad=)``) after one eager run on the engine's capture
stream (no other owner captures there: :func:`device.capture_stream`), all
buckets in one memory pool, then one replay a batch, one at a time. A
capture takes the process's capture lock, so no two run at once, and is
made in ``thread_local`` mode: other threads may go on replaying, copying
and allocating on the card while it runs (a server's request threads,
while a hot reload warms a new engine). :meth:`close` frees the graphs.
The CPU runs the same code without a graph.

``latency`` holds the wall time of every ``recommend`` and, once per
request, of every ``recommend_many`` batch (``/metrics``); ``warmup``
leaves it empty.

While a ``torch.profiler`` session records, a batch marks its host
stages as spans (``utils/profiling.py``): ``serve.batch`` over
``serve.host_inputs``, ``serve.replay``, ``serve.copy_back`` (which holds
the host's wait for the device) and ``serve.assemble``. A replay records
no span, so each bucket's graph holds four timing events at the device
stages' boundaries, and a replay under a profiler books their times
(``serve.device.*_ms``).

Ranking covers only the request city's item rows by default (exact:
candidates are a subset of the city's items by construction); with
``city_bounded=False`` every serve item is ranked. ``dcnr`` artifacts at
float32 are scored by the fused tower kernel (``ops/tower.py::tower_eval``);
the other architectures, and every model at bf16 compute or storage (an
artifact trained so, or under ``bf16``), by ``DCNR.forward``.

Options, with the JAX engine's meaning:

* ``quantize_tables``: the model's embedding tables become per-row int8
  (``ops/quant.py``); x0 is gathered and dequantized by the model's lookup,
  then scored as before (the tower kernel for ``dcnr``). The retrieval-side
  item embeddings stay f32, so candidate sets do not change;
* ``bf16``: the model runs at ``compute_dtype=bfloat16`` through
  ``DCNR.forward`` (bf16 operands, f32 BatchNorm and logits; on a card the
  bf16 cross forward kernel), never through the f32 tower kernel;
* ``retrieval_embeddings``: an ``[n_items, D]`` array of learned item
  vectors in the artifact's internal item rows (``retrieval/two_tower.py``'s
  export; ``from_dirs(retrieval_embeddings_path=)`` loads one) takes the
  place of the ranker's item table in every similarity surface: kNN
  expansion, ``similar_items`` and MMR. It is swapped in before any of
  their device tensors (and so any bucket graph) is built; D may differ
  from the ranker's width. The ranking model does not change;
* ``candidate_cap``: a one-request ``recommend`` whose candidates fit the
  cap ranks only its candidate rows, compacted in ascending serve order
  into ``cap`` rows without a host sync (a cumulative sum and a scatter, so
  the bucket's CUDA graph holds it). The host reads the count after the
  copy back; a request with more candidates runs the full program instead.
  ``recommend_many`` always runs the full program. The responses are the
  uncapped engine's.

* ``mesh`` (a ``DeviceMesh`` of ``parallel/mesh.py::make_mesh``; every
  rank of the world builds the engine from the same artifact and data):
  the item axis pads to the mesh size and each rank holds its rows of the
  candidate state (``retrieval/candidates.py``), of the item features and
  of the train table of ``similar_items``; the model, ``embedded`` and
  ``emb_norm`` are whole on every rank (as the train table of the
  queries is). A batch scores each rank's ``[K, Mp/W]`` rows through the
  model's route (one ``tower_eval`` launch a rank for f32 ``dcnr``) and
  all-gathers the scores with the candidate mask in one collective; rank
  0 then takes the stable order and runs the single-device MMR over the
  whole item axis, with no collective of its own. ``similar_items`` runs
  ``retrieval/sharded.py``. ``candidate_cap`` and ``city_bounded`` are
  switched off, as in the JAX engine. The engine joins its world's
  lockstep (``serve/lockstep.py``), which every mesh engine of the world
  shares: rank 0 leads, does the host work and starts every device call
  with a header naming the engine (and a batch's packed inputs) under the
  world's one lock, so every rank makes its collectives in one order; the
  other ranks run the world's one follower loop (:meth:`follow`), which
  dispatches each call to the engine it names, builds the engines rank 0
  builds (``World.build``) and ends at the world's :meth:`shutdown`.
  :meth:`close` frees the engine on every rank and leaves the world up. A
  device call that fails part way ends rank 0's process (code 1), and its
  launcher (the port's ``launch`` or torchrun) stops every rank. On an
  NCCL world each bucket is a CUDA graph with its collectives inside (the
  input broadcast stays before the replay), replayed only under the world
  lock; a gloo world cannot capture its collectives and runs the same
  launches eagerly. The engine logs which (``self.graphs``). Responses
  equal the single-device engine's.

Edge semantics match the reference:
unknown user → model id ``n_users // 2``; no candidates → a message
response; λ = 1.0 returns the full sorted candidate list, λ < 1 the MMR
top-20.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from hhrs_tpu_torch.config import RetrievalConfig, round_up
from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_friendships_csv, load_reviews_csv
from hhrs_tpu_torch.data.preprocess import encode_item_features
from hhrs_tpu_torch.data.table import first_occurrence, isna, take
from hhrs_tpu_torch.device import capture_stream, resolve_device
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.ops.mmr import NEG_INF, mmr_rerank
from hhrs_tpu_torch.ops.quant import quantize_embedding_params
from hhrs_tpu_torch.ops.tower import (TOWER_TOL, build_x0, fold_eval_params, score_rows, tower_eval,
                                      tower_eval_ref, uses_tower)
from hhrs_tpu_torch.retrieval.candidates import CandidateGenerator, ServeUniverse
from hhrs_tpu_torch.parallel.mesh import all_gather, mesh_size, row_shardings
from hhrs_tpu_torch.retrieval.graph import FriendGraph
from hhrs_tpu_torch.retrieval.sharded import shard_k, sharded_cosine_topk
from hhrs_tpu_torch.retrieval.similarity import cosine_topk, normalize_rows, require_full_f32_matmul
from hhrs_tpu_torch.serve.lockstep import OP_BATCH, OP_SIMILAR, world_of
from hhrs_tpu_torch.train.artifacts import ArtifactBundle, load_artifact_bundle
from hhrs_tpu_torch.utils import profiling
from hhrs_tpu_torch.utils.logging import LatencyHistogram
from hhrs_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)

# Held by every CUDA-graph capture of the process: torch.cuda.graph
# synchronizes the card and empties the allocator's cache as it starts,
# which must not happen inside another thread's capture.
_CAPTURE_LOCK = threading.Lock()


class _Bucket(NamedTuple):
    """A batch size's CUDA graph (full or capped) and its static buffers."""

    graph: torch.cuda.CUDAGraph
    host: torch.Tensor  # pinned int32 [Kp, S + 3], the upload's source
    inputs: torch.Tensor  # int32 [Kp, S + 3] on the card, the graph's input
    out: torch.Tensor  # int64 [Kp, W + top_k + 1] on the card, the graph's output
    marks: tuple | None  # timing events captured at the stage boundaries (None under a mesh)


STAGES = ("retrieval", "ranking", "mmr")  # the device stages between a bucket's marks


def _record(marks: tuple | None, i: int) -> None:
    """Record stage boundary ``i`` of :data:`STAGES` (0 before retrieval,
    3 after MMR) into the graph being captured; nothing outside a capture."""
    if marks is not None:
        marks[i].record()


def bucket_size(K: int, pad_to: int | None = None) -> int:
    """Rows a batch of ``K >= 1`` requests runs at: ``pad_to`` when it is
    at least K, else the next power of two."""
    if pad_to is not None and pad_to >= K:
        return pad_to
    return 1 << (K - 1).bit_length()


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
        bf16: bool = False,
        quantize_tables: bool = False,
        candidate_cap: int = 0,
        use_pallas: bool = False,
        retrieval_embeddings=None,
        mesh=None,
    ):
        if mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh of parallel/mesh.py::make_mesh, got {type(mesh).__name__}")
            if candidate_cap:
                log.warning("candidate_cap is ignored under --mesh (arbitrary-row gathers from sharded "
                            "arrays); the row-sharded full-universe program is the mesh fast path")
                candidate_cap = 0
            city_bounded = False  # the row-sharded full item axis is the mesh program
        self.mesh = mesh
        if use_pallas:
            log.warning("use_pallas is retired in the JAX engine and a no-op here: "
                        "scoring does not change")
        if retrieval_embeddings is not None:
            table = np.asarray(retrieval_embeddings, np.float32)
            if table.shape[0] != bundle.item_embeddings.shape[0]:
                raise ValueError(
                    f"retrieval_embeddings rows ({table.shape[0]}) != the artifact's internal item "
                    f"count ({bundle.item_embeddings.shape[0]})")
            bundle = dataclasses.replace(bundle, item_embeddings=table)
        self.latency = LatencyHistogram()
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
            universe=uni, device=dev, mesh=mesh,
        )
        rows = self.gen.items  # this rank's item rows (all of them without a mesh)

        # Serve-item feature matrix: the first row of each item, in
        # serve-index order (the reference's drop_duplicates ranking frame).
        items = take(main, first_occurrence(main[schema.ITEM_COL]))
        _, x_cat, x_num = encode_item_features(art, items)
        item_internal = self.gen.s2t_np  # unknown → 0 (fallback parity)
        emb_serve = np.asarray(bundle.item_embeddings[item_internal], np.float32)

        def local(a, dtype, layout=rows):  # the rank's rows, zero padded
            a = np.asarray(a)
            a = np.concatenate([a, np.zeros((layout.padded - layout.n, *a.shape[1:]), a.dtype)])
            return torch.as_tensor(a[layout.start:layout.stop], dtype=dtype, device=dev)

        self._dev = {  # the item features sharded; MMR's inputs whole on every rank
            "item_internal": local(item_internal, torch.int64),
            "x_cat": local(x_cat, torch.int64),
            "x_num": local(x_num, torch.float32),
            "embedded": torch.as_tensor(self.gen.s2t_valid_np, dtype=torch.bool, device=dev),
            "emb_norm": normalize_rows(torch.as_tensor(emb_serve, dtype=torch.float32, device=dev)),
        }
        # similar_items: the queries' table, whole on every rank as in JAX, and
        # the normalized table searched (under a mesh, the rank's rows of it)
        self._emb_train = torch.as_tensor(bundle.item_embeddings, dtype=torch.float32, device=dev)
        self._train_rows = row_shardings(mesh, bundle.item_embeddings.shape[0])
        self._table_norm_train = normalize_rows(local(bundle.item_embeddings, torch.float32, self._train_rows))
        self._reverse_item_map = {v: k for k, v in art.item_id_mapping.items()}

        cfg = bundle.model_cfg
        params = bundle.params
        if quantize_tables:
            params = quantize_embedding_params(params)
        if bf16:
            cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        self.model = dcnr_from_jax(params, bundle.bn_state, bundle.dims, cfg, dev)
        tables = "int8 tables" if quantize_tables else "f32 tables"
        if uses_tower(cfg):
            self._folded = fold_eval_params(self.model)
            self.scoring = f"the fused f32 tower kernel (ops/tower.py) on x0 from {tables}"
        else:
            self._folded = None
            self.scoring = (f"DCNR.forward at compute {cfg.compute_dtype} / storage {cfg.storage_dtype} "
                            f"from {tables}")
        log.info("arch %s: scoring through %s", cfg.arch, self.scoring)

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
        self._order_width = W if self._city_bounded else self.gen.Mp
        # the cap applies where it is narrower than the rows ranked without it
        self._cap = int(candidate_cap) if 0 < candidate_cap < self._order_width else 0
        self.cap_branches = {"capped": 0, "full": 0}  # one-request calls answered by each branch
        self._count_lock = threading.Lock()
        self._all_rows = torch.arange(rows.rows, dtype=torch.int64, device=dev)
        self._buckets: dict = {}  # (Kp, capped) -> _Bucket (on a card)
        self._graph_lock = threading.Lock()  # one replay at a time: buckets share buffers and a pool
        self._graph_pool = None
        self._graph_stream = capture_stream(self, dev) if dev.type == "cuda" else None
        # Buckets run as CUDA graphs on a card, under a mesh only on NCCL:
        # gloo's collectives cannot be captured.
        self.graphs = dev.type == "cuda" and (mesh is None or dist.get_backend() == "nccl")
        if mesh is not None:
            self._world = world_of(mesh, dev)
            self._leader = self._world.leader
            self._wire = self._world.wire
            self._closed = False
            self._engine_id = self._world.attach(self)  # last: a failed construction joins no world
            log.info("mesh %s (%s, %d ranks): rank %d holds item rows [%d, %d) of %d as engine %d; %s",
                     tuple(mesh.shape), dist.get_backend(), mesh_size(mesh), dist.get_rank(), rows.start, rows.stop,
                     rows.padded, self._engine_id,
                     "CUDA graphs with the collectives inside" if self.graphs else "eager launches (no graphs)")

    # ------------------------------------------------------------------ #

    def _logits(self, users, items, x_cat, x_num) -> torch.Tensor:
        return score_rows(self.model, self._folded, users, items, x_cat, x_num)

    @torch.no_grad()
    def _rank_rows(self, cand, count, user_internal, lam, idx, marks=None) -> torch.Tensor:
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
        _record(marks, 2)
        return self._order_and_mmr(scores, valid, count, lam, idx, safe)

    def _order_and_mmr(self, scores, valid, count, lam, idx, safe) -> torch.Tensor:
        """The stable order and the MMR picks of the scored rows ``idx``
        (``safe``: clamped into M) → the packed output."""
        d = self._dev
        mmr = mmr_rerank(
            scores, d["emb_norm"][safe], valid, d["embedded"][safe] & valid, lam,
            top_k=self.retrieval_cfg.mmr_top_k,
        )
        order = torch.gather(idx, 1, torch.argsort(-scores, dim=1, stable=True))
        mmr_idx = torch.where(mmr >= 0, torch.gather(idx, 1, torch.clamp(mmr, min=0)), -1)
        return torch.cat([order, mmr_idx, count[:, None]], dim=1)

    def _rank_full(self, cand, count, user_internal, lam, marks=None) -> torch.Tensor:
        """Every serve item ranked (``city_bounded=False``)."""
        idx = self._all_rows.expand(cand.shape[0], -1)
        return self._rank_rows(cand, count, user_internal, lam, idx, marks)

    def _rank_sharded(self, cand, count, user_internal, lam) -> torch.Tensor:
        """Under a mesh: score this rank's ``[K, Mp/W]`` rows (one scoring
        call), gather every rank's scores and candidate mask in one
        collective, then (rank 0) rank the whole padded axis as
        :meth:`_rank_full` does; pad rows are never candidates. The other
        ranks' output (the scores) is not read."""
        K, m = cand.shape
        d = self._dev
        flat = self._all_rows.expand(K, -1).reshape(-1)
        users = user_internal[:, None].expand(K, m).reshape(-1)
        logits = self._logits(users, d["item_internal"][flat], d["x_cat"][flat], d["x_num"][flat])
        scores = torch.where(cand, logits.reshape(K, m), torch.full((), NEG_INF, device=cand.device))
        every = all_gather(torch.stack([scores, cand.to(scores.dtype)])).permute(1, 2, 0, 3).reshape(2, K, self.gen.Mp)
        if not self._leader:
            return every
        idx = torch.arange(self.gen.Mp, device=cand.device).expand(K, -1)
        return self._order_and_mmr(every[0], every[1] > 0, count, lam, idx, torch.clamp(idx, max=self.gen.M - 1))

    def _rank_capped(self, cand, count, user_internal, lam, marks=None) -> torch.Tensor:
        """The JAX engine's ``_rank_capped``: rank only the first ``cap``
        candidate rows in ascending serve order (all of them when ``count <=
        cap``, the only case whose output is read), padded with M, then pad
        the order section back to the order width. ``nonzero`` would sync
        with the host; a cumulative sum gives each candidate its slot and a
        scatter puts it there, slot ``cap`` taking the overflow."""
        M, cap = self.gen.M, self._cap
        K = cand.shape[0]
        slot = torch.cumsum(cand, dim=1) - 1
        slot = torch.where(cand & (slot < cap), slot, cap)
        idx = torch.full((K, cap + 1), M, dtype=torch.int64, device=cand.device)
        idx.scatter_(1, slot, self._all_rows.expand(K, -1))
        packed = self._rank_rows(cand, count, user_internal, lam, idx[:, :cap], marks)
        pad = torch.zeros((K, self._order_width - cap), dtype=packed.dtype, device=packed.device)
        return torch.cat([packed[:, :cap], pad, packed[:, cap:]], dim=1)

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
        """One request: the one-request program, which takes the
        ``candidate_cap`` branch when its candidates fit."""
        t0 = time.perf_counter()
        req = [(user_id, city, mode, lambda_param)]
        out = self._recommend(req, None, graphed=self.graphs, capped=bool(self._cap))[0]
        self.latency.observe(time.perf_counter() - t0)
        return out

    def recommend_many(self, requests: list, pad_to: int | None = None) -> list:
        """``[(user_id, city, mode, lambda_param), …]`` → responses. The batch
        runs at :func:`bucket_size` rows with one upload and one device→host
        copy; on a card as one replay of the bucket's CUDA graph."""
        t0 = time.perf_counter()
        out = self._recommend(requests, pad_to, graphed=self.graphs)
        dt = time.perf_counter() - t0
        for _ in out:
            self.latency.observe(dt)  # the whole batch's wall time, once per request
        return out

    def _recommend_eager(self, requests: list, pad_to: int | None = None, capped: bool = False) -> list:
        """:meth:`recommend_many` (with ``capped``, one-request
        :meth:`recommend`) with the same launches run one by one, no graph:
        the reference that the graphed path is held to."""
        return self._recommend(requests, pad_to, graphed=False, capped=capped and bool(self._cap))

    def _recommend(self, requests: list, pad_to: int | None, graphed: bool, capped: bool = False) -> list:
        K = len(requests)
        if K == 0:
            return []
        if self.mesh is not None and not self._leader:
            raise RuntimeError("rank 0 leads a mesh engine; the other ranks run follow()")
        with span("serve.batch"):
            S = self.gen.max_sources
            with span("serve.host_inputs"):
                host = np.empty((bucket_size(K, pad_to), S + 3), np.int32)
                for k, (u, c, mode, _l) in enumerate(requests):
                    host[k, :S], host[k, S], host[k, S + 1] = self._host_inputs(u, c, mode)
                host[:K, S + 2] = np.asarray([r[3] for r in requests], np.float32).view(np.int32)
                host[K:] = host[K - 1]  # pad rows copy the last real row

            def run(capped: bool) -> np.ndarray:
                if self.mesh is not None:
                    return self._mesh_batch(host, graphed).numpy()
                if graphed:
                    return self._replay(host, capped).numpy()
                out = self._device_rank(torch.from_numpy(host).to(self.device), capped)
                with span("serve.copy_back"):
                    return out.cpu().numpy()

            packed = run(capped)
            if capped:
                fits = packed[0, -1] <= self._cap
                with self._count_lock:
                    self.cap_branches["capped" if fits else "full"] += 1
                if not fits:
                    packed = run(False)
            with span("serve.assemble"):
                return [self._assemble(u, l, packed[k]) for k, (u, _c, _m, l) in enumerate(requests)]

    @torch.no_grad()
    def _device_rank(self, inputs: torch.Tensor, capped: bool = False, marks: tuple | None = None) -> torch.Tensor:
        """The device work of a batch: the packed int32 ``[Kp, S + 3]``
        inputs → the packed int64 ``[Kp, W + top_k + 1]`` output; with
        ``capped``, ranked on the compacted candidate rows. ``marks``: the
        four timing events of a capture, recorded at the stage boundaries
        (single device only)."""
        _record(marks, 0)
        S = self.gen.max_sources
        sources, city, user = inputs[:, :S].long(), inputs[:, S].long(), inputs[:, S + 1].long()
        lam = inputs.view(torch.float32)[:, S + 2]
        cand, _neg, count = self.gen.generate_batch(sources, city)
        _record(marks, 1)
        if self.mesh is not None:
            return self._rank_sharded(cand, count, user, lam)
        if capped:
            out = self._rank_capped(cand, count, user, lam, marks)
        elif self._city_bounded:
            rows = self.gen.dev["city_rows"][torch.clamp(city, max=len(self.gen.universe.cities))]
            out = self._rank_rows(cand, count, user, lam, rows, marks)
        else:
            out = self._rank_full(cand, count, user, lam, marks)
        _record(marks, 3)
        return out

    def _replay(self, host: np.ndarray, capped: bool) -> torch.Tensor:
        """Run ``host`` through its bucket's CUDA graph, full or capped
        (captured on first use) → the packed output on the host. While a
        profiler records, books each stage's device time from the marks
        the replay recorded (``serve.device.<stage>_ms``): the copy back
        has waited for them, and the lock keeps the next replay off them."""
        with self._graph_lock:
            b = (self._buckets.get((host.shape[0], capped))
                 or self._capture(torch.from_numpy(host).to(self.device), capped))
            with span("serve.replay"):
                b.host.numpy()[...] = host
                b.inputs.copy_(b.host, non_blocking=True)
                b.graph.replay()
            with span("serve.copy_back"):
                out = b.out.cpu()  # the one device→host copy; it waits for the replay
            if profiling.recording():
                for stage, start, end in zip(STAGES, b.marks, b.marks[1:]):
                    profiling.book(f"serve.device.{stage}_ms", start.elapsed_time(end))
            return out

    def _capture(self, inputs: torch.Tensor, capped: bool) -> _Bucket:
        """Capture the bucket of ``inputs``' row count (full or capped) with
        ``inputs`` (on the card) as its static input. One eager run on the
        capture stream first sets up what a capture cannot: the tower
        kernel's launch plan for Kp·W rows (timed with events and a
        synchronize at its first use), the kernels' libraries, cuBLAS's
        workspace. On a single device the graph also records the four
        timing events of :data:`STAGES` (``external``: event nodes that each
        replay records); the eager run records none."""
        profiling.count("build.graph_capture")
        stream, current = self._graph_stream, torch.cuda.current_stream(self.device)
        marks = None if self.mesh is not None else tuple(
            torch.cuda.Event(enable_timing=True, external=True) for _ in range(len(STAGES) + 1))
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self._device_rank(inputs, capped)
        current.wait_stream(stream)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, torch.cuda.graph(graph, pool=self._graph_pool, stream=stream,
                                             capture_error_mode="thread_local"):
            out = self._device_rank(inputs, capped, marks)
        b = _Bucket(graph, torch.empty(inputs.shape, dtype=torch.int32, pin_memory=True), inputs, out, marks)
        self._buckets[(inputs.shape[0], capped)] = b
        log.info("captured the %s serving graph of a %d-request bucket", "capped" if capped else "full",
                 inputs.shape[0])
        return b

    # ---- the mesh lockstep (serve/lockstep.py) ----------------------------- #

    def _lockstep(self):
        """One device call of this mesh engine under its world's lock (rank
        0 raises first when the engine is closed or the world stopped; a
        call that fails part way ends rank 0)."""
        return self._world.lockstep(self)

    def _send(self, op: int, a: int = 0, b: int = 0) -> None:
        """Rank 0: the header of this engine's next device call."""
        self._world.send(op, self._engine_id, a, b)

    def _mesh_batch(self, host: np.ndarray | None, graphed: bool, Kp: int = 0) -> torch.Tensor | None:
        """Every rank's part of one batch: rank 0 sends the header and its
        packed inputs ``host``, every rank runs the bucket (the capture at
        its first use), and rank 0 gets the packed output on the host."""
        with self._lockstep():
            if self._leader:
                Kp = host.shape[0]
                self._send(OP_BATCH, Kp, int(graphed))
            shape = (Kp, self.gen.max_sources + 3)
            b = self._buckets.get((Kp, False)) if graphed else None
            if self._wire.type == "cpu":  # gloo: the inputs travel on the host
                inputs = torch.from_numpy(host) if self._leader else torch.empty(shape, dtype=torch.int32)
                dist.broadcast(inputs, 0)
                inputs = inputs.to(self.device)
            else:  # NCCL: on the card, into the bucket's static input once it exists
                inputs = b.inputs if b is not None else torch.empty(shape, dtype=torch.int32, device=self.device)
                if self._leader:
                    inputs.copy_(torch.from_numpy(host))
                dist.broadcast(inputs, 0)
            if graphed:
                b = b or self._capture(inputs, False)
                if b.inputs is not inputs:
                    b.inputs.copy_(inputs)
                b.graph.replay()
                out = b.out
            else:
                out = self._device_rank(inputs)
            return out.cpu() if self._leader else None

    def follow(self) -> None:
        """Every rank of a mesh engine's world but 0: the world's follower
        loop (every engine of the world), until its :meth:`shutdown`."""
        if self.mesh is None or self._leader:
            raise RuntimeError("follow() is for the ranks of a mesh engine other than 0")
        self._world.follow()

    def shutdown(self) -> None:
        """Rank 0 of a mesh engine: shut its world down, ending every other
        rank's :meth:`follow` (idempotent); later device calls of the
        world's engines raise."""
        if self.mesh is None or not self._leader:
            return
        self._world.shutdown()

    def close(self) -> None:
        """Free the card memory of the engine's CUDA graphs and their
        buffers (a hot reload closes the engine it swapped out once its
        last requests are done); a later request captures its bucket
        again. A mesh engine is closed on every rank of its world (CLOSE),
        and its later requests raise; the world stays up."""
        if self.mesh is not None:
            self._world.close(self)
        self._free_graphs()

    def _free_graphs(self) -> None:
        with self._graph_lock:
            for b in self._buckets.values():
                b.graph.reset()
            self._buckets.clear()
            self._graph_pool = None

    # ------------------------------------------------------------------ #

    @torch.no_grad()
    def similar_items(self, item_id: int, n: int = 10) -> list | None:
        """Top-n similar items; None if the item is unknown."""
        internal = self.bundle.preproc.item_id_mapping.get(item_id)
        if internal is None:
            return None
        if self.mesh is None:
            _, idx = cosine_topk(self._table_norm_train, self._emb_train[internal][None, :], n + 1)
        else:
            shard_k(n + 1, self._train_rows.padded, mesh_size(self.mesh))  # raises here, before any rank starts
            with self._lockstep():
                self._send(OP_SIMILAR, internal, n)
                idx = self._similar_sharded(internal, n)
        neighbours = idx[0, 1:].cpu().tolist()  # drop the first hit (self)
        return [int(self._reverse_item_map[t]) for t in neighbours if t in self._reverse_item_map]

    @torch.no_grad()
    def tower_check(self, user: int = 0) -> dict | None:
        """The tower kernel on the engine's item rows (a rank's rows under a
        mesh) for one model user, against its plain version on the same x0
        → rows, the largest |kernel − plain| and the logits outside
        ``TOWER_TOL`` (rtol and atol); None when the engine does not score
        through the tower. A world build runs it on every rank (COMMIT)."""
        if self._folded is None:
            return None
        d = self._dev
        users = torch.full(d["item_internal"].shape, user, dtype=torch.int64, device=self.device)
        x0 = build_x0(self.model, users, d["item_internal"], d["x_cat"], d["x_num"]).contiguous()
        variant = self.model.cfg.cross_variant
        out, ref = tower_eval(self._folded, x0, variant), tower_eval_ref(self._folded, x0, variant)
        err = (out - ref).abs()
        return {"rows": int(x0.shape[0]), "max_abs_err": float(err.max()) if err.numel() else 0.0,
                "outside": int((err > TOWER_TOL + TOWER_TOL * ref.abs()).sum())}

    def _similar_sharded(self, internal: int, n: int) -> torch.Tensor:
        _, idx = sharded_cosine_topk(self.mesh, self._table_norm_train, self._emb_train[internal][None, :], n + 1,
                                     n_valid=self._train_rows.n)
        return idx

    def warmup(self, batch_pad: int | None = None) -> None:
        """Serve one request of each kind before traffic (builds the kernels
        and, on a card, captures the one-request graph); ``batch_pad`` also
        runs, and captures, the bucket of that many rows. Ends with an empty
        ``latency``: warm-up samples never reach ``/metrics``."""
        uni = self.gen.universe
        if uni.n_users and uni.cities:
            u, c = int(uni.user_ids[0]), uni.cities[0]
            self.recommend(u, c, "friends", 0.7)
            self.recommend(u, c, "personal", 1.0)
            if self._cap:  # the full one-request program, which a request over the cap runs
                self.recommend_many([(u, c, "friends", 0.7)])
            if batch_pad:
                self.recommend_many([(u, c, "friends", 0.7)], pad_to=batch_pad)
        self.latency = LatencyHistogram()

    @classmethod
    def from_dirs(cls, artifacts_dir: str, data_dir: str, retrieval_cfg=None,
                  device: str | torch.device | None = None, city_bounded: bool = True,
                  bf16: bool = False, quantize_tables: bool = False, candidate_cap: int = 0,
                  use_pallas: bool = False, frames: tuple | None = None,
                  retrieval_embeddings_path: str | None = None,
                  mesh=None) -> "RecommendationEngine":
        """Load an artifact directory and the serve CSVs
        (``hackathon_augmented_data.csv``, ``friendships.csv``) from
        ``data_dir``, or take them parsed as ``frames=(main, friendships)``
        (:func:`load_frames`), which skips the parse. ``device`` defaults to
        ``cuda`` and raises without one. ``retrieval_embeddings_path``: an
        ``.npy`` of learned retrieval vectors (the ``retrieval_embeddings``
        option). The engine's ``artifacts_dir`` names what it serves
        (``/healthz``, the hot-reload poller)."""
        device = resolve_device(device)
        bundle = load_artifact_bundle(artifacts_dir)
        main, friendships = frames if frames is not None else load_frames(data_dir)
        table = np.load(retrieval_embeddings_path) if retrieval_embeddings_path else None
        eng = cls(bundle, main, friendships, retrieval_cfg, device=device, city_bounded=city_bounded,
                  bf16=bf16, quantize_tables=quantize_tables, candidate_cap=candidate_cap,
                  use_pallas=use_pallas, retrieval_embeddings=table, mesh=mesh)
        eng.artifacts_dir = artifacts_dir
        return eng


def load_frames(data_dir: str) -> tuple:
    """``(main, friendships)`` tables parsed from a data directory's serve
    CSVs, the reviews with their engineered features."""
    return (
        add_engineered_features(load_reviews_csv(os.path.join(data_dir, "hackathon_augmented_data.csv"))),
        load_friendships_csv(os.path.join(data_dir, "friendships.csv")),
    )
