"""What every rank of a CPU gloo world runs for ``tests/test_torch_port_mesh.py``.

Kept apart from the test module, which imports JAX: each rank imports only
torch and the port. :func:`mesh_checks` runs every mesh check of the test
module in one world, so each world is spawned once per module, and rank 0
returns the answers for the tests to compare with the JAX package's.
:func:`faulty_batch` is a world whose rank 0 fails part way through a
batch.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.parallel.mesh import make_mesh, row_shardings
from hhrs_tpu_torch.retrieval.sharded import make_sharded_topk_fn
from hhrs_tpu_torch.retrieval.similarity import normalize_rows
from hhrs_tpu_torch.serve.engine import RecommendationEngine
from hhrs_tpu_torch.serve.sharded_scoring import ShardedItemScorer
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle


def _led(engine, work):
    """Rank 0 runs ``work(engine)`` and returns its value; the other ranks
    follow until rank 0 shuts the engine down."""
    if dist.get_rank() != 0:
        engine.follow()
        return None
    try:
        return work(engine)
    finally:
        engine.shutdown()


def _engine_answers(spec: dict):
    """Every request of the test module's sweep through one mesh engine."""

    def work(eng):
        return {
            "sweep": [eng.recommend(*r) for r in spec["requests"]],
            "many": eng.recommend_many(spec["many"]),
            "edge": [eng.recommend(*r) for r in spec["edge"]],
            "similar": [eng.similar_items(i, n) for i, n in spec["similar"]],
            "order_width": eng._order_width,
        }

    return work


def mesh_checks(spec: dict) -> dict:
    """Every mesh check at this world's size (rank 0's answers, None on the
    other ranks). ``spec``: the artifact and data dirs, the requests, the
    similarity table and queries, and the scorer's item arrays."""
    torch.set_num_threads(1)
    mesh = make_mesh(-1, 1, "cpu")
    out = {"shape": tuple(mesh.shape)}

    # sharded_cosine_topk over this rank's rows of the padded table
    table = torch.as_tensor(spec["table"])
    rows = row_shardings(mesh, table.shape[0])
    padded = torch.cat([normalize_rows(table), torch.zeros(rows.padded - rows.n, table.shape[1])])
    queries = torch.as_tensor(spec["queries"])
    out["topk"] = {k: [t.numpy() for t in make_sharded_topk_fn(mesh, k, n_valid=rows.n)(
        padded[rows.start:rows.stop], queries)] for k in spec["ks"]}

    # ShardedItemScorer on the artifact's model
    bundle = load_artifact_bundle(spec["artifacts"])
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, "cpu")
    scorer = ShardedItemScorer(mesh, model, *spec["scorer_items"], device="cpu")
    out["score_all"] = {u: scorer.score_all(u).numpy() for u in spec["scorer_users"]}
    out["score_top_k"] = {(u, k): [t.numpy() for t in scorer.top_k(u, k)]
                          for u in spec["scorer_users"] for k in spec["ks"]}

    def engine(**options):
        return RecommendationEngine.from_dirs(spec["artifacts"], spec["data"], device="cpu", mesh=mesh, **options)

    plain = engine()
    out["candidates"] = [plain.gen.generate(u, c, m, plain.graph) for u, c, m in spec["candidates"]]
    out["plain"] = _led(plain, _engine_answers(spec))
    out["quantized"] = _led(engine(quantize_tables=True), lambda e: [e.recommend(*r) for r in spec["quantized"]])
    out["retrieval"] = _led(engine(retrieval_embeddings_path=spec["retrieval"]),
                            lambda e: ([e.recommend(*r) for r in spec["quantized"]],
                                       [e.similar_items(i, n) for i, n in spec["similar"]]))
    capped = engine(candidate_cap=16, city_bounded=True)
    out["switched_off"] = (capped._cap, capped._city_bounded)
    out["capped"] = _led(capped, lambda e: e.recommend(*spec["requests"][0]))
    return out if dist.get_rank() == 0 else None


def faulty_batch(spec: dict) -> str | None:
    """A mesh engine whose rank 0 fails inside its second batch, after the
    header and the inputs went out (the followers are in its collectives).
    Rank 0's process must end there, so this never returns on rank 0."""
    torch.set_num_threads(1)
    engine = RecommendationEngine.from_dirs(spec["artifacts"], spec["data"], device="cpu",
                                            mesh=make_mesh(-1, 1, "cpu"))
    if dist.get_rank() != 0:
        engine.follow()
        return None
    engine.recommend(*spec["requests"][0])

    def fault(*args, **kwargs):
        raise RuntimeError("an injected device fault")

    engine._device_rank = fault
    engine.recommend(*spec["requests"][0])
    return "rank 0 served on after a fault"
