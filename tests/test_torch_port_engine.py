"""Serve-engine parity: the PyTorch port (on the CPU) against the JAX engine
on the shipped hpo_r5 artifact and the data/ CSVs, plus the golden file.

The golden file ``hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json`` holds
the JAX engine's responses, and the JAX logits of every ranked hotel, for
the sweep below; ``serve_golden_hpo_r5_int8.json`` and
``serve_golden_hpo_r5_bf16.json`` hold the same for the JAX engine with
``quantize_tables`` and with ``bf16`` (the latter also the f32 logits of the
same hotels, which set its swap bar). ``chip_smoke.py`` holds the card
against them. Regenerate all three with
``python tests/test_torch_port_engine.py --write``.

The engine options are held to the JAX engine with the same option over
the whole sweep: ``quantize_tables`` and ``candidate_cap`` to equal JSON;
``bf16`` to equal JSON except two hotels may trade places where their JAX
bf16 logits differ by less than ``BF16_BAR · max |JAX bf16 − JAX f32|``
over the golden file's hotels (``bf16_swap_bar``), the model bar of
``tests/test_torch_port_model.py``.
"""

from __future__ import annotations

import ast
import dataclasses
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
from hhrs_tpu_torch.serve.engine import RecommendationEngine, bucket_size  # noqa: E402
from tests.test_torch_port_model import BF16_BAR  # noqa: E402
from tests.test_torch_port_model import one_torch_thread  # noqa: F401,E402 — module fixture

ARTIFACT = str(REPO / "benchmarks/results/hpo_r5/best")
DATA = str(REPO / "data")
GOLDEN = REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json"
# The JAX engine with an option: (golden file, options).
OPTION_GOLDEN = {
    "int8": (REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5_int8.json", {"quantize_tables": True}),
    "bf16": (REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5_bf16.json", {"bf16": True}),
}
OPTIONS = {"int8": {"quantize_tables": True}, "bf16": {"bf16": True}, "cap16": {"candidate_cap": 16}}
SWAP_TOL = 1e-4  # the golden tie rule (chip_smoke.py)
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


def jax_ranked_logits(je, reqs, responses, cfg=None) -> list:
    """The JAX model's logit of every ranked hotel of every response (one
    batched apply_dcn call, split per response), at the engine's model
    config or ``cfg``."""
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
        np.asarray(dev["X_num"])[rows], cfg=cfg or je._cfg, train=False,
    )
    flat = [float(x) for x in np.asarray(logits)]
    bounds = np.cumsum([0] + sizes)
    return [flat[a:b] for a, b in zip(bounds[:-1], bounds[1:])]


def make_golden(je, options: dict | None = None) -> dict:
    reqs = sweep(je)
    responses = [je.recommend(*r) for r in reqs]
    many_idx = list(range(0, len(reqs), 17))[:8]
    items = [int(i) for i in je.gen.universe.item_ids[:4]]
    similar = [[i, 10, je.similar_items(i, 10)] for i in items]
    similar += [[items[0], 3, je.similar_items(items[0], 3)], [999999, 10, je.similar_items(999999, 10)]]
    golden = {
        "artifact": "benchmarks/results/hpo_r5/best",
        "data": "data",
        "requests": reqs,
        "responses": responses,
        "logits": jax_ranked_logits(je, reqs, responses),
        "many": many_idx,
        "similar": similar,
    }
    if options:
        golden["options"] = options
    if je._cfg.compute_dtype == "bfloat16":
        f32 = dataclasses.replace(je._cfg, compute_dtype="float32", storage_dtype="float32")
        golden["logits_f32"] = jax_ranked_logits(je, reqs, responses, f32)
    return golden


def bf16_swap_bar(golden: dict) -> float:
    """``BF16_BAR`` times the largest |JAX bf16 − JAX f32| logit over the
    bf16 golden file's hotels."""
    dev = max(abs(a - b) for xs, ys in zip(golden["logits"], golden["logits_f32"]) for a, b in zip(xs, ys))
    return BF16_BAR * dev


def tie_swaps(got: dict, want: dict, logits: list, tol: float) -> int:
    """Number of places where ``got`` has another hotel than ``want``; two
    hotels may trade places only where their logits (``want``'s) differ by
    less than ``tol``, and every hotel's payload must be equal."""
    assert set(got) == set(want) and got.get("message") == want.get("message")
    g, w = got["ranked_hotels"], want["ranked_hotels"]
    assert len(g) == len(w)
    logit = {h["hotel_id"]: x for h, x in zip(w, logits)}
    payload = {h["hotel_id"]: h for h in w}
    swaps = 0
    for gh, wh in zip(g, w):
        assert gh == payload[gh["hotel_id"]]
        if gh["hotel_id"] != wh["hotel_id"]:
            assert abs(logit[gh["hotel_id"]] - logit[wh["hotel_id"]]) < tol, (gh["hotel_id"], wh["hotel_id"])
            swaps += 1
    return swaps


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


# (K, pad_to): the power-of-two buckets 1, 4, 8, 8 without pad_to; pad_to
# 8 at every K; and a pad_to below K, which falls back to the bucket.
PAD_CASES = [(1, None), (3, None), (5, None), (8, None), (1, 8), (3, 8), (5, 8), (8, 8), (5, 2)]


@pytest.mark.parametrize("city_bounded", [True, False])
@pytest.mark.parametrize("K,pad_to", PAD_CASES)
def test_recommend_many_pad_to_matches_jax_engine(jax_engines, torch_engines, golden, city_bounded, K,
                                                  pad_to):
    """Pad rows copy the last real row and only the K real rows are
    answered: the JSON equals the JAX engine's for the same pad_to."""
    je, te = jax_engines[city_bounded], torch_engines[city_bounded]
    reqs = golden["requests"][5 * K::13][:K]  # users, cities, modes and λ mixed
    assert len(reqs) == K
    got = te.recommend_many(reqs, pad_to=pad_to)
    assert got == je.recommend_many(reqs, pad_to=pad_to)
    assert got == [je.recommend(*r) for r in reqs]


@pytest.mark.parametrize("K,pad_to,want", [(1, None, 1), (2, None, 2), (3, None, 4), (5, None, 8), (8, None, 8),
                                           (9, None, 16), (3, 8, 8), (8, 8, 8), (9, 8, 16), (5, 5, 5)])
def test_bucket_size_is_the_jax_engines(K, pad_to, want):
    assert bucket_size(K, pad_to) == want


def test_warmup_runs_the_padded_bucket_on_the_cpu(torch_engines, golden):
    te = torch_engines[True]
    te.warmup(batch_pad=4)
    assert te._buckets == {}  # graphs are captured on a card only
    assert te._recommend_eager(golden["requests"][:3], pad_to=4) == golden["responses"][:3]


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


@pytest.mark.parametrize("option,value", [("mesh", object())])
def test_unported_options_raise(option, value):
    # mesh serving is ported (tests/test_torch_port_mesh.py): a mesh that
    # is not a DeviceMesh of parallel/mesh.py is refused
    with pytest.raises(TypeError, match="DeviceMesh"):
        RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", **{option: value})


@pytest.fixture(scope="module")
def option_engines():
    """(name, city_bounded) → (JAX engine, port engine) with that option."""
    return {
        (name, cb): (JaxEngine.from_dirs(ARTIFACT, DATA, city_bounded=cb, **opts),
                     RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", city_bounded=cb, **opts))
        for name, opts in OPTIONS.items() for cb in (True, False)
    }


@pytest.fixture(scope="module")
def option_goldens():
    return {name: json.loads(path.read_text()) for name, (path, _) in OPTION_GOLDEN.items()}


@pytest.mark.parametrize("city_bounded", [True, False])
@pytest.mark.parametrize("name", ["int8", "cap16"])
def test_option_engine_json_equals_jax_engines(option_engines, golden, name, city_bounded):
    """quantize_tables and candidate_cap=16: the port's JSON equals the JAX
    engine's with the same option on every request of the sweep."""
    je, te = option_engines[(name, city_bounded)]
    for req in golden["requests"]:
        assert te.recommend(*req) == je.recommend(*req), req


@pytest.mark.parametrize("city_bounded", [True, False])
def test_bf16_engine_json_equals_jax_engines_up_to_the_bar(option_engines, option_goldens, city_bounded,
                                                           record_property):
    """bf16: the port's JSON equals the JAX bf16 engine's, except hotels
    whose JAX bf16 logits differ by less than bf16_swap_bar may trade
    places (their logits from the golden file, whose responses are the JAX
    engine's own)."""
    je, te = option_engines[("bf16", city_bounded)]
    golden = option_goldens["bf16"]
    tol = bf16_swap_bar(golden)
    assert 0 < tol < 2e-3
    reqs = golden["requests"]
    wants = [json.loads(json.dumps(je.recommend(*r))) for r in reqs]
    logits = golden["logits"] if city_bounded else jax_ranked_logits(je, reqs, wants)
    swaps = sum(tie_swaps(json.loads(json.dumps(te.recommend(*r))), w, x, tol)
                for r, w, x in zip(reqs, wants, logits))
    record_property("swaps_inside_the_bar", swaps)


@pytest.mark.parametrize("city_bounded", [True, False])
def test_capped_engine_json_equals_the_uncapped_port(option_engines, torch_engines, golden, city_bounded):
    """candidate_cap=16 takes both branches over the sweep and answers
    exactly as the uncapped engine; recommend_many never takes the cap."""
    capped, full = option_engines[("cap16", city_bounded)][1], torch_engines[city_bounded]
    assert capped._cap == 16
    before = dict(capped.cap_branches)
    for req in golden["requests"]:
        assert capped.recommend(*req) == full.recommend(*req), req
    took = {k: capped.cap_branches[k] - before[k] for k in before}
    assert took["capped"] > 0 and took["full"] > 0 and sum(took.values()) == len(golden["requests"])
    many = [golden["requests"][i] for i in golden["many"]]
    counts = dict(capped.cap_branches)
    assert capped.recommend_many(many) == full.recommend_many(many)
    assert capped.recommend_many(many[:1]) == full.recommend_many(many[:1])
    assert capped.cap_branches == counts


def test_cap_wider_than_the_ranked_rows_is_off():
    te = RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", candidate_cap=10_000)
    assert te._cap == 0


@pytest.mark.parametrize("name", sorted(OPTION_GOLDEN))
def test_jax_engine_reproduces_option_golden(option_engines, option_goldens, name):
    je = option_engines[(name, True)][0]
    golden = option_goldens[name]
    assert golden["options"] == OPTION_GOLDEN[name][1]
    assert golden["requests"] == sweep(je)
    assert [je.recommend(*r) for r in golden["requests"]] == golden["responses"]


@pytest.mark.parametrize("city_bounded", [True, False])
def test_int8_port_matches_its_golden_under_the_tie_rule(option_engines, option_goldens, city_bounded):
    """The file chip_smoke.py holds the card to, on the CPU: 0 swaps."""
    te = option_engines[("int8", city_bounded)][1]
    golden = option_goldens["int8"]
    swaps = sum(tie_swaps(json.loads(json.dumps(te.recommend(*r))), w, x, SWAP_TOL)
                for r, w, x in zip(golden["requests"], golden["responses"], golden["logits"]))
    assert swaps == 0


def test_option_engines_score_through_the_stated_path(option_engines):
    """int8 and capped dcnr engines score through the tower kernel (f32, on
    the x0 the model's lookup dequantizes); the bf16 engine through
    DCNR.forward at compute bfloat16. Item embeddings (retrieval, MMR,
    similar_items) stay f32 under every option."""
    for (name, _), (_, te) in option_engines.items():
        assert (te._folded is None) == (name == "bf16"), name
        assert te.model.cfg.compute_dtype == ("bfloat16" if name == "bf16" else "float32")
        assert te._dev["emb_norm"].dtype == torch.float32
    int8 = option_engines[("int8", True)][1].model
    from hhrs_tpu_torch.ops.quant import QuantizedTable

    assert isinstance(int8.user_embedding, QuantizedTable) and int8.user_embedding.values.dtype == torch.int8
    assert all(isinstance(t, QuantizedTable) for t in int8.cat_embeddings)
    assert "DCNR.forward at compute bfloat16" in option_engines[("bf16", True)][1].scoring


FORBIDDEN = {"jax", "flax", "optax", "hhrs_tpu", "pandas", "msgpack", "pydantic"}


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
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    for path, options in [(GOLDEN, {}), *OPTION_GOLDEN.values()]:
        engine = JaxEngine.from_dirs(ARTIFACT, DATA, **options)
        path.write_text(json.dumps(make_golden(engine, options), separators=(",", ":")) + "\n")
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")
