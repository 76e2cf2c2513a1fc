"""The serving stack above the engine, the port's against the JAX package's:
the engine's latency histogram and ``from_dirs(frames=, use_pallas=)``,
the dynamic batcher, the response cache, canary routing and its per-arm
stats, shadow agreement, and the serve CLI (its flags, and a real
process on the CPU that answers and drains on SIGTERM).

Primary model: the shipped hpo_r5 artifact; candidate: a copy of it with
seeded noise on every weight (written by the JAX package), both on
``data/``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hhrs_tpu.serve import cache as jax_cache
from hhrs_tpu.serve import canary as jax_canary
from hhrs_tpu.serve import cli as jax_cli
from hhrs_tpu.serve import reload as jax_reload
from hhrs_tpu.serve import shadow as jax_shadow
from hhrs_tpu.serve.engine import RecommendationEngine as JaxEngine
from hhrs_tpu.train.artifacts import export_artifacts, load_artifact_bundle
from hhrs_tpu_torch.serve import batcher, cache, canary, cli, reload, shadow
from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = str(REPO / "benchmarks/results/hpo_r5/best")
DATA = str(REPO / "data")


def perturbed_artifact(out: str, seed: int = 1, scale: float = 0.05, source: str = ARTIFACT) -> str:
    """``source`` (hpo_r5 by default) with seeded noise on every parameter:
    another model of the same shapes and vocabulary."""
    b = load_artifact_bundle(source)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
                          b.params)
    export_artifacts(out, params, b.bn_state, b.model_cfg, b.dims, b.preproc, b.metrics)
    return out


@pytest.fixture(scope="module")
def engines(tmp_path_factory, one_torch_thread):  # noqa: F811
    candidate = perturbed_artifact(str(tmp_path_factory.mktemp("stack") / "candidate"))
    frames = load_frames(DATA)
    return {
        "jax": JaxEngine.from_dirs(ARTIFACT, DATA), "jax_candidate": JaxEngine.from_dirs(candidate, DATA),
        "port": RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", frames=frames),
        "port_candidate": RecommendationEngine.from_dirs(candidate, DATA, device="cpu", frames=frames),
        "candidate_dir": candidate,
    }


def requests(engine, n: int) -> list:
    uni = engine.gen.universe
    return [(int(uni.user_ids[(7 * i) % uni.n_users]), uni.cities[i % len(uni.cities)],
             ("friends", "personal")[i % 2], (0.7, 1.0, 0.3)[i % 3]) for i in range(n)]


# ---------------------------------------------------------------- the engine

def test_latency_counts_follow_jax(engines):
    """recommend observes once, recommend_many once per request, warmup
    leaves the histogram empty; the same calls count the same in JAX."""
    je, te = engines["jax"], engines["port"]
    reqs = requests(te, 5)
    for eng in (je, te):
        eng.warmup(batch_pad=8)
        assert eng.latency.summary() == {"count": 0, "p50_ms": None, "p90_ms": None, "p99_ms": None}
        eng.recommend(*reqs[0])
        eng.recommend_many(reqs, pad_to=8)
    assert te.latency.summary()["count"] == je.latency.summary()["count"] == 6
    assert set(te.latency.summary()) == set(je.latency.summary())


def test_from_dirs_frames_use_pallas_and_artifacts_dir(engines, caplog):
    te = engines["port"]
    assert te.artifacts_dir == engines["jax"].artifacts_dir == ARTIFACT
    with caplog.at_level("WARNING"):
        parsed = RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", use_pallas=True)
    assert any("use_pallas" in r.message for r in caplog.records)
    reqs = requests(te, 6)
    assert [parsed.recommend(*r) for r in reqs] == [te.recommend(*r) for r in reqs]


def test_engine_is_safe_under_16_threads():
    """16 threads on one CPU engine (with a candidate cap, so both
    branches count): every answer equals the sequential one, and no branch
    count is lost."""
    te = RecommendationEngine.from_dirs(ARTIFACT, DATA, device="cpu", candidate_cap=16)
    reqs = requests(te, 48)
    want = [te.recommend(*r) for r in reqs]
    before = sum(te.cap_branches.values())
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            got = list(ex.map(lambda r: te.recommend(*r), reqs * 2))
    finally:
        sys.setswitchinterval(interval)
    assert got == want * 2
    assert sum(te.cap_branches.values()) - before == 2 * len(reqs)
    assert min(te.cap_branches.values()) > 0
    te.close()  # frees no graph on the CPU; the engine still answers
    assert te.recommend(*reqs[0]) == want[0]


# ---------------------------------------------------------------- the batcher

def test_batcher_under_16_threads_equals_sequential(engines):
    te, je = engines["port"], engines["jax"]
    reqs = requests(te, 32)
    want = [te.recommend(*r) for r in reqs]
    assert want == [je.recommend(*r) for r in reqs]
    front = batcher.BatchingEngine(te, max_batch=8, window_ms=20.0)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            assert list(ex.map(lambda r: front.recommend(*r), reqs)) == want
        item = int(te.gen.universe.item_ids[0])
        assert front.similar_items(item, 3) == te.similar_items(item, 3)
        assert front.latency is te.latency
    finally:
        front.close()


def test_batcher_errors_and_close():
    class Boom:
        closed = 0

        def recommend_many(self, reqs, pad_to=None):
            raise RuntimeError("boom")

        def close(self):
            Boom.closed += 1

    front = batcher.BatchingEngine(Boom(), max_batch=2, window_ms=1.0)
    with pytest.raises(RuntimeError, match="boom"):
        front.recommend(1, "X", "friends", 0.7)
    front.close()
    assert Boom.closed == 1  # closing the batcher closes its engine
    with pytest.raises(RuntimeError, match="closed"):
        front.recommend(1, "X", "friends", 0.7)


# ---------------------------------------------------------------- the cache

def _cache_script(cache_mod, reload_mod, engine, fresh_engine) -> list:
    """tests/test_serve.py::test_response_cache's steps; returns what each
    step saw."""
    reqs = requests(engine, 3)
    seen = []
    cached = cache_mod.CachedEngine(engine, max_entries=2)
    a = cached.recommend(*reqs[0])
    b = cached.recommend(*reqs[0])
    seen += [a is b, a, cached.cache_stats()]
    seen += [cached.recommend_many(reqs[:2]), cached.cache_stats()]
    cached.recommend(*reqs[2])
    seen.append(cached.cache_stats())
    ttl = cache_mod.CachedEngine(engine, max_entries=8, ttl_s=0.01)
    ttl.recommend(*reqs[0])
    time.sleep(0.05)
    ttl.recommend(*reqs[0])
    seen.append(ttl.cache_stats())
    sim = cache_mod.CachedEngine(engine, max_entries=8)
    item = int(next(iter(engine.bundle.preproc.item_id_mapping)))
    seen += [sim.similar_items(item, 5), sim.similar_items(item, 5), sim.similar_items(-12345, 5),
             sim.similar_items(-12345, 5), sim.cache_stats()]
    holder = reload_mod.SwappableEngine(engine)
    swapped = cache_mod.CachedEngine(holder, max_entries=8)
    r1 = swapped.recommend(*reqs[0])
    holder.swap(fresh_engine)
    r2 = swapped.recommend(*reqs[0])
    seen += [r1 == r2, r1 is r2, swapped.cache_stats()]
    return seen


def test_cache_counts_and_invalidation_match_jax(engines):
    got = _cache_script(cache, reload, engines["port"], engines["port_candidate"])
    want = _cache_script(jax_cache, jax_reload, engines["jax"], engines["jax_candidate"])
    assert got == want
    assert got[0] is True and got[-2] is False  # a hit is the cached object; a swap clears


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cache_single_flight(pkg):
    """A stampede of identical misses computes once; a failing leader does
    not poison its followers (tests/test_serve.py::test_cache_single_flight)."""
    mod = {"jax": jax_cache, "port": cache}[pkg]
    calls, barrier = [], threading.Barrier(8)

    class Slow:
        def recommend(self, u, c, m, l):
            calls.append((u, c))
            time.sleep(0.05)
            return {"u": u, "c": c}

    cached = mod.CachedEngine(Slow(), max_entries=32)

    def hit(u):
        barrier.wait()
        return cached.recommend(u, "X", "friends", 0.7)

    with ThreadPoolExecutor(max_workers=8) as ex:
        res = list(ex.map(hit, [1] * 6 + [2, 3]))
    assert res == [{"u": 1, "c": "X"}] * 6 + [{"u": 2, "c": "X"}, {"u": 3, "c": "X"}]
    assert sorted(calls) == [(1, "X"), (2, "X"), (3, "X")]
    assert cached.cache_stats() == {"entries": 3, "hits": 5, "misses": 3}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_cache_never_serves_a_preswap_response(pkg):
    cache_mod, reload_mod = {"jax": (jax_cache, jax_reload), "port": (cache, reload)}[pkg]

    class Fake:
        def __init__(self, tag):
            self.tag = tag

        def recommend(self, u, c, m, l):
            time.sleep(0.002)
            return {"tag": self.tag}

    holder = reload_mod.SwappableEngine(Fake("gen0"))
    cached = cache_mod.CachedEngine(holder, max_entries=8)
    for i in range(1, 20):
        t = threading.Thread(target=lambda: cached.recommend(1, "X", "friends", 0.7))
        t.start()
        time.sleep(0.001)
        holder.swap(Fake(f"gen{i}"))
        t.join(10)
        assert not t.is_alive()
        assert cached.recommend(1, "X", "friends", 0.7)["tag"] == f"gen{i}"


# ---------------------------------------------------------------- canary and shadow

def test_canary_routing_equals_jax():
    for salt in ("", "release-2", "candidate/dir"):
        for fraction in (0.1, 0.5):
            got = [canary.routes_to_canary(u, fraction, salt) for u in range(10_000)]
            assert got == [jax_canary.routes_to_canary(u, fraction, salt) for u in range(10_000)]


def test_canary_stats_match_jax(engines):
    reqs = requests(engines["port"], 24)
    stats, outs = {}, {}
    for pkg, mod in (("jax", jax_canary), ("port", canary)):
        ce = mod.CanaryEngine(engines[pkg], engines[f"{pkg}_candidate"], 0.5, salt="s")
        outs[pkg] = [ce.recommend(*r) for r in reqs] + ce.recommend_many(reqs[:9], pad_to=16)
        stats[pkg] = ce.canary_stats()
        assert stats[pkg].pop("canary_latency")["count"] > 0
    assert outs["port"] == outs["jax"]
    assert stats["port"] == stats["jax"]
    assert 0 < stats["port"]["canary_served"] < 33 and stats["port"]["errors"] == 0

    class Exploding:
        artifacts_dir = "boom"

        def recommend(self, *a):
            raise RuntimeError("canary boom")

        def recommend_many(self, requests, pad_to=None):
            raise RuntimeError("canary boom")

    ce = canary.CanaryEngine(engines["port"], Exploding(), 1.0)
    assert ce.recommend(*reqs[0]) == engines["port"].recommend(*reqs[0])
    assert ce.recommend_many(reqs[:2]) == engines["port"].recommend_many(reqs[:2])
    assert ce.canary_stats() == {"canary_model": "boom", "fraction": 1.0, "salt": "", "primary_served": 3,
                                 "canary_served": 0, "errors": 3}


def test_shadow_overlap_and_stats_match_jax(engines):
    reqs = requests(engines["port"], 16)
    primary = [engines["port"].recommend(*r) for r in reqs]
    other = [engines["port_candidate"].recommend(*r) for r in reqs]
    empty = {"ranked_hotels": []}
    for a, b in list(zip(primary, other)) + [(empty, empty), (primary[0], empty), (empty, primary[0])]:
        assert shadow.overlap_metrics(a, b) == jax_shadow.overlap_metrics(a, b)
    stats = {}
    for pkg, mod in (("jax", jax_shadow), ("port", shadow)):
        se = mod.ShadowEngine(engines[pkg], engines[f"{pkg}_candidate"], queue_size=64)
        for r in reqs[:8]:
            assert se.recommend(*r) == engines[pkg].recommend(*r)
        se.recommend_many(reqs[8:], pad_to=8)
        assert se.drain(30)
        stats[pkg] = se.shadow_stats()
        se.close()  # stops the worker; a closed CPU engine still answers
    assert stats["port"] == stats["jax"]
    assert stats["port"]["compared"] == 16 and stats["port"]["dropped"] == stats["port"]["errors"] == 0


# ---------------------------------------------------------------- the CLI

def _jax_parser() -> argparse.ArgumentParser:
    """The parser hhrs_tpu/serve/cli.py builds inside main()."""
    grabbed = {}

    def grab(self, args=None, namespace=None):
        grabbed["p"] = self
        raise SystemExit(0)

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            jax_cli.main([])
    finally:
        argparse.ArgumentParser.parse_args = original
    return grabbed["p"]


def _flags(parser) -> dict:
    return {a.dest: (tuple(a.option_strings), type(a).__name__, a.type, a.default, a.nargs, a.metavar)
            for a in parser._actions if a.dest != "help"}


def test_cli_flags_equal_jax_plus_device():
    got, want = _flags(cli.build_parser()), _flags(_jax_parser())
    assert got.pop("device") == (("--device",), "_StoreAction", None, None, None, None)
    assert got == want


def test_cli_refuses_unported_flags_and_a_missing_card(monkeypatch):
    # --mesh composes with every stack flag: nothing refuses the combination any more
    assert not hasattr(cli, "_refuse_unported")
    for flags in (["--shadow", "x"], ["--canary", "x"], ["--reload-poll-s", "5"], ["--data-poll-s", "5"]):
        args = cli.build_parser().parse_args(["--mesh", "4x2", "--device", "cpu", *flags])
        assert args.mesh == "4x2" and (args.shadow or args.canary or args.reload_poll_s or args.data_poll_s)
    # --retrieval-embeddings (A10) is served: the stack's engine holds the table
    table = REPO / "hhrs_tpu_torch/testdata/retrieval_embeddings_hpo_r5.npy"
    args = cli.build_parser().parse_args(["--artifacts", ARTIFACT, "--data", DATA, "--device", "cpu",
                                          "--no-warmup", "--retrieval-embeddings", str(table)])
    np.testing.assert_array_equal(cli.build_stack(args).engine.bundle.item_embeddings, np.load(table))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--artifacts", ARTIFACT, "--data", DATA])


def test_cli_stack_is_built_in_the_jax_order(engines, tmp_path):
    """engine → batcher → swappable holder and pollers → canary → cache →
    shadow, as hhrs_tpu/serve/cli.py builds it; a request through it is
    answered by the arm its user routes to."""
    from hhrs_tpu_torch.db.registry import ModelRegistry

    db = str(tmp_path / "reg.sqlite")
    ModelRegistry(db, create=True).register("v1", ARTIFACT)
    candidate = engines["candidate_dir"]
    args = cli.build_parser().parse_args(
        ["--artifacts", f"registry:{db}", "--data", DATA, "--device", "cpu", "--batch-window-ms", "2",
         "--reload-poll-s", "3600", "--data-poll-s", "3600", "--canary", candidate, "--canary-fraction", "0.5",
         "--cache-entries", "8", "--shadow", candidate, "--warm-http-batch"])
    stack = cli.build_stack(args)
    try:
        layers, node = [], stack.engine
        for attr in ("_primary", "_inner", "_primary", "current", "_engine"):
            layers.append(type(node).__name__)
            node = getattr(node, attr)
        layers.append(type(node).__name__)
        assert layers == ["ShadowEngine", "CachedEngine", "CanaryEngine", "SwappableEngine", "BatchingEngine",
                          "RecommendationEngine"]
        assert stack.reloader.is_alive() and stack.data_reloader.is_alive()
        for req in requests(engines["port"], 4):
            arm = "port_candidate" if canary.routes_to_canary(req[0], 0.5) else "port"
            assert stack.engine.recommend(*req) == engines[arm].recommend(*req)
        assert stack.engine.current.artifacts_dir == os.path.abspath(ARTIFACT)
    finally:
        stack.reloader.stop()
        stack.data_reloader.stop()
        stack.engine.close()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_on_the_cpu_and_drains_on_sigterm():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hhrs_tpu_torch.serve.cli", "--artifacts", ARTIFACT, "--data", DATA,
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--batch-window-ms", "2",
         "--cache-entries", "16"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline, health = time.monotonic() + 60, None
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                time.sleep(0.2)
        assert health is not None and health["status"] == "ok", proc.poll()
        assert health["model"] == ARTIFACT and health["cache"] == {"entries": 0, "hits": 0, "misses": 0}
        body = json.dumps({"user_id": 15, "city": "Sochi"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/recommendations", data=body)
        with urllib.request.urlopen(req, timeout=30) as r:
            assert r.status == 200 and "ranked_hotels" in json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    out = proc.stdout.read().decode()
    proc.stdout.close()
    assert "draining" in out and "shutdown complete" in out

