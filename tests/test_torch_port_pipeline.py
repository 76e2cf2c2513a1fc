"""The port's continuous-training pipeline (``hhrs_tpu_torch/pipeline.py``)
through tests/test_pipeline.py's cases, on the CPU: a cold then a warm
cycle and a watched drop, a bad drop survived, training from a snapshot,
the gate under the trainer's layered config, and a promotion picked up by
a registry hot reload of the port's engine.
"""

from __future__ import annotations

import json
import os
import threading
import time

import pytest

from hhrs_tpu_torch import pipeline
from hhrs_tpu_torch.data.synthetic import append_reviews, write_synthetic_dataset
from hhrs_tpu_torch.db.registry import ModelRegistry
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

# tests/test_pipeline.py's tiny model and batches, on the CPU
OVR = ["model.emb_dim=8", "model.hidden_dim=32", "model.n_cross_layers=1", "model.n_res_blocks=1",
       "train.batch_size=256"]
CPU = ["--device", "cpu"]


def _history(runs_dir: str) -> list:
    with open(os.path.join(runs_dir, "pipeline_history.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_pipeline_cold_warm_and_watch(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_users=150, n_items=60, n_reviews=3000, seed=9)
    db, runs = str(tmp_path / "reg.sqlite"), str(tmp_path / "runs")
    base = ["--data", data, "--db", db, "--runs-dir", runs, *CPU]

    # cycle 1: no registry → a cold run, promoted (no incumbent)
    assert pipeline.main(base + ["--once", "--epochs", "1"] + OVR) == 0
    active = ModelRegistry(db).active()
    h = _history(runs)
    assert h[-1]["ok"] and h[-1]["promoted"] is True and h[-1]["warm_start_from"] is None
    assert h[-1]["run_dir"] == active["artifact_path"]
    assert h[-1]["train_s"] > 0 and h[-1]["gate_s"] > 0
    first = active["artifact_path"]

    # a fresh drop, cycle 2: warm start from the active model, both re-scored
    append_reviews(data, 77_000_001, n=8)
    assert pipeline.main(base + ["--once", "--epochs", "1"] + OVR) == 0
    h = _history(runs)
    assert h[-1]["ok"] and h[-1]["warm_start_from"] == first
    assert isinstance(h[-1]["promoted"], bool) and h[-1]["reason"]
    models = ModelRegistry(db).list()
    assert len(models) == 2 and sum(m["is_active"] for m in models) == 1
    cand = next(m for m in models if m["artifact_path"] == h[-1]["run_dir"])
    assert "gate_logloss" in cand["metrics"] and h[-1]["snapshot"] is True
    assert cand["metrics"]["gate_eval_data"] == os.path.abspath(data)

    # watch: a drop mid-watch triggers one more cycle, then --max-cycles ends it
    done = {}

    def watch():
        done["rc"] = pipeline.main(base + ["--poll-s", "0.05", "--max-cycles", "1", "--epochs", "1"] + OVR)

    t = threading.Thread(target=watch, daemon=True)
    t.start()
    time.sleep(1.0)  # the watcher's baseline fingerprint comes before the drop
    append_reviews(data, 77_000_002, n=8)
    t.join(timeout=120)
    assert not t.is_alive() and done["rc"] == 0
    h = _history(runs)
    assert len(h) == 3 and h[-1]["ok"] and h[-1]["trigger_fingerprint"]
    assert len(ModelRegistry(db).list()) == 3


def test_pipeline_once_survives_bad_data(tmp_path):
    data = str(tmp_path / "data")
    os.makedirs(data)
    with open(os.path.join(data, "hackathon_augmented_data.csv"), "w") as f:
        f.write("guest_id,hotel_id\n1,2\n")  # required columns missing
    db, runs = str(tmp_path / "reg.sqlite"), str(tmp_path / "runs")
    assert pipeline.main(["--data", data, "--db", db, "--runs-dir", runs, "--once", "--epochs", "1", *CPU] + OVR) == 1
    h = _history(runs)
    assert h[-1]["ok"] is False and h[-1]["stage"] == "train" and "error" in h[-1]
    assert not os.path.exists(db) or ModelRegistry(db).active() is None


def test_pipeline_trains_from_snapshot_not_live_dir(tmp_path, monkeypatch):
    import hhrs_tpu_torch.train.cli as train_cli

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_users=60, n_items=30, n_reviews=800, seed=3)
    seen = {}

    def fake_train(argv):
        i = argv.index("--data")
        seen["data_arg"] = argv[i + 1]
        append_reviews(data, 42_000_000)  # a writer changes the live dir during the run
        seen["snapshot_size"] = os.path.getsize(os.path.join(argv[i + 1], "hackathon_augmented_data.csv"))
        seen["device"] = argv[argv.index("--device") + 1]
        return 1

    monkeypatch.setattr(train_cli, "main", fake_train)
    rec = pipeline.run_cycle(data, str(tmp_path / "reg.sqlite"), str(tmp_path / "runs"), epochs=1, device="cpu")
    assert rec["snapshot"] is True and seen["data_arg"] != data and seen["device"] == "cpu"
    assert seen["snapshot_size"] < os.path.getsize(os.path.join(data, "hackathon_augmented_data.csv"))
    assert rec["ok"] is False and rec["stage"] == "train"
    assert not os.path.exists(seen["data_arg"])  # the snapshot is removed after the cycle


def test_pipeline_gate_runs_under_the_trainer_config(tmp_path, monkeypatch):
    import hhrs_tpu_torch.db.cli as db_cli

    captured = {}
    real = db_cli.run_promote

    def spy(*a, **kw):
        captured.update(kw)
        return real(*a, **kw)

    monkeypatch.setattr(db_cli, "run_promote", spy)
    monkeypatch.setenv("HHRS_DATA_NEGATIVE_RATING", "3")
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_users=80, n_items=40, n_reviews=1200, seed=6)
    assert pipeline.main(["--data", data, "--db", str(tmp_path / "r.sqlite"), "--runs-dir", str(tmp_path / "runs"),
                          "--once", "--epochs", "1", *CPU, "data.positive_rating=7"] + OVR) == 0
    assert captured["cfg"].data.positive_rating == 7 and captured["cfg"].data.negative_rating == 3
    assert captured["record_eval_data"] == data and captured["device"] == "cpu"


def test_pipeline_two_cycles_within_a_second_get_their_own_dirs(tmp_path):
    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_users=60, n_items=30, n_reviews=800, seed=4)
    db, runs = str(tmp_path / "reg.sqlite"), str(tmp_path / "runs")
    recs = [pipeline.run_cycle(data, db, runs, epochs=1, overrides=OVR, device="cpu", warm_start=False)
            for _ in range(3)]
    assert all(r["ok"] for r in recs)
    assert len({r["run_dir"] for r in recs}) == 3


@pytest.fixture
def cpu_engine_builder():
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    def make(data):
        return lambda adir: RecommendationEngine.from_dirs(adir, data, device="cpu")

    return make


def test_pipeline_promotion_feeds_registry_hot_reload(tmp_path, cpu_engine_builder):
    from hhrs_tpu_torch.serve.reload import RegistryReloader, SwappableEngine

    data = str(tmp_path / "data")
    write_synthetic_dataset(data, n_users=120, n_items=50, n_reviews=2500, seed=5)
    db, runs = str(tmp_path / "reg.sqlite"), str(tmp_path / "runs")
    base = ["--data", data, "--db", db, "--runs-dir", runs, "--once", "--epochs", "1", *CPU] + OVR
    assert pipeline.main(base) == 0
    v1 = ModelRegistry(db).active()["artifact_path"]
    build = cpu_engine_builder(data)
    holder = SwappableEngine(build(v1))
    reloader = RegistryReloader(holder, f"registry:{db}", build, poll_s=3600, current_dir=v1)
    assert reloader.check_once() is False

    append_reviews(data, 66_000_001, n=6)
    assert pipeline.main(base) == 0
    active = ModelRegistry(db).active()["artifact_path"]
    if _history(runs)[-1]["promoted"]:
        assert active == _history(runs)[-1]["run_dir"] and reloader.check_once() is True
    else:
        assert active == v1
        reloader.check_once()
    assert holder.artifacts_dir == active
    uni = holder.gen.universe
    assert "ranked_hotels" in holder.recommend(int(uni.user_ids[0]), uni.cities[0], "friends", 1.0)
