"""Serve-engine parity: the PyTorch port (on the CPU) against the JAX engine
on the shipped hpo_r5 artifact and the data/ CSVs, plus the golden file.

The golden file ``hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json`` holds
the JAX engine's responses, and the JAX logits of every ranked hotel, for
the sweep below; ``chip_smoke.py`` holds the card against it. Regenerate
it with ``python tests/test_torch_port_engine.py --write``.
"""

from __future__ import annotations

import ast
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:  # for the --write entry point
    sys.path.insert(0, str(REPO))

from hhrs_tpu.models.dcn import apply_dcn  # noqa: E402
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine  # noqa: E402
from hhrs_tpu_torch.serve.engine import RecommendationEngine  # noqa: E402
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

ARTIFACT = str(REPO / "benchmarks/results/hpo_r5/best")
DATA = str(REPO / "data")
GOLDEN = REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json"
UNKNOWN_USER = 424242
UNKNOWN_CITY = "Atlantis"


def sweep(engine) -> list:
    """Known users with friends, a known friendless user and an unknown
    user; all cities and an unknown one; both modes; λ ∈ {0.7, 1.0}."""
    uni = engine.gen.universe
    known = [int(u) for u in uni.user_ids[:3]]
    friendless = next(
        int(u) for u in uni.user_ids if len(engine.graph.friend_indices(int(u))) == 0
    )
    users = known + [friendless, UNKNOWN_USER]
    cities = list(uni.cities) + [UNKNOWN_CITY]
    return [
        [u, c, m, lam]
        for u in users for c in cities for m in ("friends", "personal") for lam in (0.7, 1.0)
    ]


def jax_ranked_logits(je, reqs, responses) -> list:
    """The JAX model's logit of every ranked hotel of every response (one
    batched apply_dcn call, split per response)."""
    uni = je.gen.universe
    rows, users, sizes = [], [], []
    for req, resp in zip(reqs, responses):
        idx = [uni.item_index[h["hotel_id"]] for h in resp["ranked_hotels"]]
        rows += idx
        users += [je._user_map.get(req[0], je._unknown_user)] * len(idx)
        sizes.append(len(idx))
    rows = np.asarray(rows, np.int32)
    dev = je._dev
    logits, _ = apply_dcn(
        dev["params"], dev["bn_state"], np.asarray(users, np.int32),
        np.asarray(dev["item_internal"])[rows], np.asarray(dev["X_cat"])[rows],
        np.asarray(dev["X_num"])[rows], cfg=je._cfg, train=False,
    )
    flat = [float(x) for x in np.asarray(logits)]
    bounds = np.cumsum([0] + sizes)
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def make_golden(je) -> dict:
    reqs = sweep(je)
    responses = [je.recommend(*r) for r in reqs]
    many_idx = list(range(0, len(reqs), 17))[:8]
    items = [int(i) for i in je.gen.universe.item_ids[:4]]
    similar = [[i, 10, je.similar_items(i, 10)] for i in items]
    similar += [[items[0], 3, je.similar_items(items[0], 3)], [999999, 10, je.similar_items(999999, 10)]]
    return {
        "artifact": "benchmarks/results/hpo_r5/best",
        "data": "data",
        "requests": reqs,
        "responses": responses,
        "logits": jax_ranked_logits(je, reqs, responses),
        "many": many_idx,
        "similar": similar,
    }


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_engines():
    return {cb: JaxEngine.from_dirs(ARTIFACT, DATA, city_bounded=cb) for cb in (True, False)}


@pytest.fixture(scope="module")
def torch_engines():
    return {
        cb: RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", city_bounded=cb)
        for cb in (True, False)
    }


def test_jax_engine_reproduces_golden(jax_engines, golden):
    je = jax_engines[True]
    assert golden["requests"] == sweep(je)
    assert [je.recommend(*r) for r in golden["requests"]] == golden["responses"]
    got = jax_ranked_logits(je, golden["requests"], golden["responses"])
    np.testing.assert_allclose(
        np.concatenate([np.asarray(x, np.float64) for x in got]),
        np.concatenate([np.asarray(x, np.float64) for x in golden["logits"]]),
        rtol=1e-6, atol=1e-6,
    )


@pytest.mark.parametrize("city_bounded", [True, False])
def test_port_matches_jax_engine_json(jax_engines, torch_engines, golden, city_bounded):
    je, te = jax_engines[city_bounded], torch_engines[city_bounded]
    assert te._city_bounded == city_bounded
    assert sweep(te) == golden["requests"]
    for req in golden["requests"]:
        assert te.recommend(*req) == je.recommend(*req), req


@pytest.mark.parametrize("city_bounded", [True, False])
def test_port_matches_golden(torch_engines, golden, city_bounded):
    te = torch_engines[city_bounded]
    got = [te.recommend(*r) for r in golden["requests"]]
    assert json.loads(json.dumps(got)) == golden["responses"]


@pytest.mark.parametrize("city_bounded", [True, False])
def test_recommend_many_matches_single(torch_engines, golden, city_bounded):
    te = torch_engines[city_bounded]
    reqs = [golden["requests"][i] for i in golden["many"]]
    assert len(reqs) == 8
    assert te.recommend_many(reqs) == [golden["responses"][i] for i in golden["many"]]
    # a batch mixing every request of the sweep gives the same answers too
    assert te.recommend_many(golden["requests"]) == golden["responses"]


def test_similar_items_match(jax_engines, torch_engines, golden):
    je, te = jax_engines[True], torch_engines[True]
    for item, n, want in golden["similar"]:
        assert te.similar_items(item, n) == want
        assert je.similar_items(item, n) == want


def test_engine_scores_dcnr_through_tower(torch_engines):
    from hhrs_tpu_torch.ops import tower

    te = torch_engines[True]
    assert te._folded is not None
    before = tower.tower_eval.launches
    te.warmup()
    assert tower.tower_eval.launches == before  # CPU tensors never launch the kernel


def test_from_dirs_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RecommendationEngine.from_dirs(ARTIFACT, DATA)


@pytest.mark.parametrize("option,value", [
    ("bf16", True), ("quantize_tables", True), ("candidate_cap", 64),
    ("mesh", object()), ("retrieval_embeddings_path", "x.npy"),
])
def test_unported_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", **{option: value})


FORBIDDEN = {"jax", "flax", "optax", "hhrs_tpu", "pandas", "msgpack"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "hhrs_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path} imports {name}"


if __name__ == "__main__":
    if "--write" not in sys.argv:
        raise SystemExit("usage: python tests/test_torch_port_engine.py --write")
    jax.config.update("jax_platforms", "cpu")
    engine = JaxEngine.from_dirs(ARTIFACT, DATA)
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(make_golden(engine), separators=(",", ":")) + "\n")
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
