"""The port's spans and counters (``hhrs_tpu_torch/utils/profiling.py``):
the registry with and without a profiler, the spans of a serving batch and
of a training epoch nested under their outer span, ``trace``'s counters
file, and the benchmark's readers of them on tiny traced runs, on the CPU;
on a card, the serving stage times of a replayed bucket against the
replay's own device time.

This file imports neither JAX nor the JAX package, so its ``cuda`` case
also runs where JAX is absent::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_port_tracing.py
"""

from __future__ import annotations

import json
import math
import statistics
import threading
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hhrs_tpu_torch.config import Config, ModelConfig, TrainConfig
from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.serve.engine import STAGES, RecommendationEngine, load_frames
from hhrs_tpu_torch.train.artifacts import ArtifactBundle
from hhrs_tpu_torch.train.cli import build_dataset
from hhrs_tpu_torch.train.trainer import train_dcn
from hhrs_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parents[1]
SERVE_CHILDREN = ("serve.host_inputs", "serve.copy_back", "serve.assemble")
TRAIN_CHILDREN = ("train.shuffle", "train.replay", "train.eval", "train.bookkeeping")


def _profiled():
    """A CPU profile that is a stretch of its own: the check before it,
    made while nothing records, ends any earlier stretch."""
    assert not profiling.recording()
    return profile(activities=[ProfilerActivity.CPU])


def _spans(prof) -> list:
    """(start, end, name) of the user annotations of a finished profile."""
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _assert_nested(spans: list, outer: str, children: tuple, n_outer: int) -> None:
    """``n_outer`` outer spans, each child span inside one of them, and each
    child name once in every outer span."""
    outers = [(s, t) for s, t, n in spans if n == outer]
    assert len(outers) == n_outer, spans
    for name in children:
        inner = [(s, t) for s, t, n in spans if n == name]
        assert len(inner) == n_outer, (name, len(inner))
        for s, t in inner:
            assert any(a <= s and t <= b for a, b in outers), name


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A synthetic data directory, its splits and one tiny trained model."""
    d = str(tmp_path_factory.mktemp("tracing_data"))
    write_synthetic_dataset(d, n_users=150, n_items=60, n_reviews=3000, seed=9)
    splits, art = build_dataset(d, Config())
    dims = ModelDims.from_artifacts(art)
    mcfg = ModelConfig(emb_dim=8, hidden_dim=32, n_cross_layers=1, n_res_blocks=1)
    result = train_dcn(splits, dims, mcfg, TrainConfig(batch_size=256, n_epochs=1), device="cpu")
    bundle = ArtifactBundle(result.params, result.bn_state, mcfg, dims, art, result.params["item_embedding"], {})
    return {"data": d, "splits": splits, "dims": dims, "mcfg": mcfg, "bundle": bundle}


def test_without_a_profiler_a_span_is_the_shared_no_op_and_book_changes_nothing():
    assert not profiling.recording()
    before = profiling.counters()
    first, second = profiling.span("test.off"), profiling.span("test.off_too")
    assert first is second
    with first:
        torch.ones(2).sum()
    profiling.book("test.off_ms", 1.0)
    assert profiling.counters() == before
    with _profiled() as prof:
        pass
    profiling.book("test.off_ms", 1.0)  # after the profile: nothing records
    assert "test.off_ms" not in profiling.counters()["booked"]
    assert not [s for s in _spans(prof) if s[2].startswith("test.off")]


def test_a_second_profiled_stretch_starts_the_registry_afresh():
    with _profiled():
        profiling.book("test.first_ms", 2.0)
        profiling.book("test.first_ms", 4.0)
    one = profiling.counters()
    assert one["booked"] == {"test.first_ms": [2, 6.0]}
    profiling.book("test.first_ms", 1.0)  # no profiler: the stretch is over and kept as it was
    assert profiling.counters() == one
    with _profiled():
        profiling.book("test.second_ms", 1.5)
    two = profiling.counters()
    assert two["stretch"] == one["stretch"] + 1
    assert two["booked"] == {"test.second_ms": [1, 1.5]}


def test_count_counts_with_no_profiler_and_within_the_stretch_with_one():
    before = profiling.counters()["counted"].get("build.test_event", 0)
    profiling.count("build.test_event")
    assert profiling.counters()["counted"]["build.test_event"] == before + 1
    with _profiled():
        profiling.count("build.test_event")
    snap = profiling.counters()
    assert snap["counted"]["build.test_event"] == before + 2
    assert snap["booked"] == {"build.test_event": [1, 1.0]}


def test_trace_writes_the_counters_beside_the_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.traced"):
            torch.ones(4).sum()
        profiling.book("test.traced_ms", 3.0)
    assert "test.traced" in (tmp_path / "trace.json").read_text()
    written = json.loads((tmp_path / "counters.json").read_text())
    assert written == profiling.counters()
    assert written["booked"] == {"test.traced_ms": [1, 3.0]}


def test_trace_starts_its_own_stretch_after_one_another_thread_left_open(tmp_path):
    def profiled_elsewhere():
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.book("test.elsewhere_ms", 5.0)

    assert not profiling.recording()  # ends this thread's earlier stretch
    worker = threading.Thread(target=profiled_elsewhere)
    worker.start()
    worker.join()
    assert profiling.counters()["booked"] == {"test.elsewhere_ms": [1, 5.0]}
    stretch = profiling.counters()["stretch"]
    with profiling.trace(str(tmp_path)):
        profiling.book("test.here_ms", 1.0)
    written = json.loads((tmp_path / "counters.json").read_text())
    assert written["stretch"] == stretch + 1
    assert written["booked"] == {"test.here_ms": [1, 1.0]}


def test_serving_spans_nest_under_each_batch(tiny):
    engine = RecommendationEngine(tiny["bundle"], *load_frames(tiny["data"]), device="cpu")
    uni = engine.gen.universe
    requests = [(int(u), uni.cities[0], "friends", 0.7) for u in uni.user_ids[:5]]
    want = engine.recommend_many(requests, pad_to=8)
    with _profiled() as prof:
        for _ in range(2):
            assert engine.recommend_many(requests, pad_to=8) == want
    spans = _spans(prof)
    _assert_nested(spans, "serve.batch", SERVE_CHILDREN, 2)
    assert not [n for *_, n in spans if n == "serve.replay"]  # no graph on the CPU
    assert not [k for k in profiling.counters()["booked"] if k.startswith("serve.device.")]


@pytest.mark.parametrize("fused", [False, True], ids=["per_step", "fused"])
def test_training_spans_nest_under_each_epoch(tiny, fused, tmp_path):
    tcfg = TrainConfig(batch_size=256, n_epochs=3, fused_epoch=fused)
    with _profiled() as prof:
        result = train_dcn(tiny["splits"], tiny["dims"], tiny["mcfg"], tcfg, device="cpu",
                           checkpoint_dir=str(tmp_path / "ck"))
    assert len(result.history) == 3
    spans = _spans(prof)
    _assert_nested(spans, "train.epoch", TRAIN_CHILDREN, 3)
    _assert_nested(spans, "train.bookkeeping", ("train.checkpoint",), 3)
    assert not [k for k in profiling.counters()["booked"] if k.startswith("train.device.")]  # no card, no events


@pytest.mark.parametrize("cell,spans", [
    ("serve.hpo_r5.metro.bulk64", ("serve_host_inputs_ms", "serve_assemble_ms")),
    ("train.ref_best.tuned", ("train_shuffle_ms", "train_bookkeeping_ms")),
])
def test_the_benchmark_reads_the_spans_and_counters_of_a_tiny_traced_run(tiny, cell, spans):
    from portbench import spec, tracing

    assert not profiling.recording()
    win = tracing.Window(torch.device("cpu"))  # the harness's own traced window
    win.start()
    if cell.startswith("serve."):
        engine = RecommendationEngine(tiny["bundle"], *load_frames(tiny["data"]), device="cpu")
        uni = engine.gen.universe
        for _ in range(3):
            engine.recommend_many([(int(u), uni.cities[0], "friends", 0.7) for u in uni.user_ids[:5]], pad_to=8)
    else:
        train_dcn(tiny["splits"], tiny["dims"], tiny["mcfg"], TrainConfig(batch_size=256, n_epochs=3,
                                                                          fused_epoch=True), device="cpu")
    win.stop()
    ctx = {"trace": win.reduce()}
    source = {m["name"]: m["source"] for m in spec.cell(cell).per_layer if m["source"].startswith("program_")}
    names = set(source)
    read = {name: spec.reader(name)(ctx) for name in names}
    for name in spans:
        assert math.isfinite(read[name]) and read[name] > 0, (name, read)
    rebuilds = f"rebuilds.{cell.split('.')[0]}"
    assert read[rebuilds] == 0
    device = {n for n in names if source[n] == "program_counter"} - {rebuilds}
    assert device and all(read[n] is None for n in device)  # no device time is booked on the CPU
    assert {n for n in names if source[n] == "program_span"} == set(spans)
    assert all(spec.reader(name)({"trace": None}) is None for name in names)  # an untraced run reads nothing


@pytest.mark.cuda
def test_cuda_stage_times_of_a_replayed_bucket_sum_to_its_replay():
    """The three stage times booked from the events captured into a
    bucket's graph sum to within 10 % of the replay's own event-timed
    device time, and 20 replays under a profiler build nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    golden = json.loads((REPO / "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json").read_text())
    requests = [golden["requests"][i % len(golden["requests"])] for i in range(64)]
    engine = RecommendationEngine.from_dirs(str(REPO / "benchmarks/results/hpo_r5/best"), str(REPO / "data"),
                                            device="cuda")
    engine.recommend_many(requests, pad_to=64)  # the capture
    built = {k: v for k, v in profiling.counters()["counted"].items() if k.startswith("build.")}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(20):
            engine.recommend_many(requests, pad_to=64)
    snap = profiling.counters()
    assert not [k for k in snap["booked"] if k.startswith("build.")], snap["booked"]
    assert {k: v for k, v in snap["counted"].items() if k.startswith("build.")} == built
    assert all(snap["booked"][f"serve.device.{s}_ms"][0] == 20 for s in STAGES), snap["booked"]
    b = engine._buckets[(64, False)]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    replay, staged = [], []
    for _ in range(20):
        start.record()
        b.graph.replay()
        end.record()
        end.synchronize()
        replay.append(start.elapsed_time(end))
        staged.append(sum(a.elapsed_time(z) for a, z in zip(b.marks, b.marks[1:])))
    r, s = statistics.median(replay), statistics.median(staged)
    assert abs(s - r) <= 0.1 * r, (s, r)
    engine.close()


@pytest.mark.cuda
def test_cuda_training_books_the_replay_and_the_eval_inside_the_epoch_marks(tiny):
    """On a card the fused epoch's replay and the val eval book their own
    device times: one replay an epoch after the first, one eval an epoch,
    and each replay within the epoch's ``step_ms`` marks (which also hold
    the permutation's upload)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    tcfg = TrainConfig(batch_size=256, n_epochs=4, fused_epoch=True)
    train_dcn(tiny["splits"], tiny["dims"], tiny["mcfg"], tcfg, device="cuda")  # builds and warms up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        result = train_dcn(tiny["splits"], tiny["dims"], tiny["mcfg"], tcfg, device="cuda")
    booked = profiling.counters()["booked"]
    steps = tiny["splits"].n_train // 256  # drop_remainder
    replay, evals = booked["train.device.replay_ms"], booked["train.device.eval_ms"]
    assert replay[0] == len(result.step_ms) == 3 and evals[0] == 4, booked
    assert 0 < replay[1] <= sum(result.step_ms) * steps, (replay, result.step_ms)
    assert evals[1] > 0
