"""The rest of serve (ROADMAP A8): the exported ranker and the batch CLI of
the port against hhrs_tpu's, on the CPU.

* ``serve/export.py``: the hpo_r5 ranker recorded with ``torch.export``
  (``build_x0`` then ``hhrs::tower_eval``, symbolic batch) scores as JAX's
  StableHLO ``ExportedRanker`` at the tower's bar, 2e-5, from one file at
  several batch sizes; loading it needs no model code.
* ``serve/batch_cli.py``: home cities are JAX's on ``data/``; every JSONL
  line is the port engine's ``recommend`` of the same request and the JAX
  batch CLI's line on the same artifact.
"""

from __future__ import annotations

import dataclasses
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hhrs_tpu.data.features import add_engineered_features as jax_features
from hhrs_tpu.data.ingest import load_reviews_csv as jax_load_reviews
from hhrs_tpu.serve.batch_cli import home_cities as jax_home_cities
from hhrs_tpu.serve.batch_cli import main as jax_batch_main
from hhrs_tpu.serve.export import ExportedRanker as JaxExportedRanker
from hhrs_tpu.serve.export import save_ranker as jax_save_ranker
from hhrs_tpu.train.artifacts import load_artifact_bundle as jax_load_bundle
from hhrs_tpu_torch.serve import batch_cli, export
from hhrs_tpu_torch.serve.engine import RecommendationEngine, load_frames
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from tests.test_torch_port_model import one_torch_thread  # noqa: F401 — module fixture

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "benchmarks/results/hpo_r5/best"
DATA = REPO / "data"
TOL = dict(rtol=2e-5, atol=2e-5)  # the tower kernel's parity bar


def _batch(dims, n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, dims.n_users, n).astype(np.int32), rng.integers(0, dims.n_items, n).astype(np.int32),
            np.stack([rng.integers(0, d, n) for _, d in dims.cat_dims], axis=1).astype(np.int32),
            rng.normal(size=(n, dims.n_num_features)).astype(np.float32))


@pytest.fixture(scope="module")
def exported(tmp_path_factory) -> dict:
    """The hpo_r5 ranker exported by both packages (JAX lowered for the CPU)."""
    tmp = tmp_path_factory.mktemp("export")
    paths = {"port": str(tmp / export.RANKER_FILE), "jax": str(tmp / "ranker.stablehlo")}
    export.save_ranker(load_artifact_bundle(str(ARTIFACT)), paths["port"], device="cpu")
    jax_save_ranker(jax_load_bundle(str(ARTIFACT)), paths["jax"], platforms=("cpu",))
    return paths


def test_exported_ranker_scores_as_jaxs_from_one_file(exported):
    """One program, batches of 1, 7 and 300 rows (the batch is symbolic):
    the logits of JAX's exported ranker at 2e-5; the program holds the
    registered tower operator and no model module."""
    dims = load_artifact_bundle(str(ARTIFACT)).dims
    ours = export.ExportedRanker.load(exported["port"], device="cpu")
    theirs = JaxExportedRanker.load(exported["jax"])
    ops = {str(n.target) for n in ours.program.graph.nodes if n.op == "call_function"}
    assert "hhrs.tower_eval.default" in ops
    for n in (1, 7, 300):
        batch = _batch(dims, n, seed=n)
        got = ours(*batch)
        assert got.shape == (n,) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(*batch)), **TOL)


def test_loading_the_ranker_imports_no_model_code(exported):
    """A fresh process that imports the export module, loads the program
    and scores with it never imports ``hhrs_tpu_torch.models``."""
    code = (
        "import sys, torch\n"
        "from hhrs_tpu_torch.serve.export import ExportedRanker\n"
        f"r = ExportedRanker.load({exported['port']!r}, device='cpu')\n"
        "out = r([0, 1], [0, 1], [[0, 0], [1, 1]], torch.zeros(2, 11))\n"
        "assert out.shape == (2,) and bool(torch.isfinite(out).all())\n"
        "assert not [m for m in sys.modules if m.startswith('hhrs_tpu_torch.models')], 'model code imported'\n"
        "assert 'hhrs_tpu' not in sys.modules and 'jax' not in sys.modules\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_export_cli_writes_ranker_pt2(tmp_path, capsys):
    adir = tmp_path / "art"
    shutil.copytree(ARTIFACT, adir)
    assert export.main(["--artifacts", str(adir), "--device", "cpu"]) == 0
    ranker = export.ExportedRanker.load(str(adir / "ranker.pt2"), device="cpu")
    batch = _batch(load_artifact_bundle(str(adir)).dims, 5)
    assert torch.isfinite(ranker(*batch)).all()
    with pytest.raises(SystemExit):
        export.main(["--artifacts", str(adir), "--device", "cpu", "--platforms", "tpu,cpu"])
    assert "takes cuda and cpu only" in capsys.readouterr().err


def test_export_of_another_architecture_names_its_roadmap_item():
    bundle = load_artifact_bundle(str(ARTIFACT))
    other = dataclasses.replace(bundle, model_cfg=dataclasses.replace(bundle.model_cfg, arch="cross_only"))
    with pytest.raises(NotImplementedError, match="A8b"):
        export.export_ranker(other, device="cpu")


def test_export_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.export_ranker(load_artifact_bundle(str(ARTIFACT)))


# ---- the batch CLI ------------------------------------------------------------------


def test_home_cities_are_jaxs_on_data():
    got = batch_cli.home_cities(load_frames(str(DATA))[0])
    want = jax_home_cities(jax_features(jax_load_reviews(str(DATA / "hackathon_augmented_data.csv"))))
    assert got == {int(k): v for k, v in want.items()} and len(got) == 2000


def test_home_cities_break_ties_by_first_review():
    table = {"user_id": np.array([1, 1, 2, 1, 2, 2, 3]),
             "city": np.array(["B", "A", "C", "A", "D", "C", np.nan], dtype=object)}
    assert batch_cli.home_cities(table) == {1: "A", 2: "C"}
    table["city"][3] = "B"
    assert batch_cli.home_cities(table) == {1: "B", 2: "C"}


@pytest.fixture(scope="module")
def engine():
    return RecommendationEngine.from_dirs(str(ARTIFACT), str(DATA), device="cpu")


@pytest.mark.parametrize("case", ["limit", "city", "users"])
def test_batch_cli_lines_are_the_engines_and_jaxs(engine, tmp_path, case):
    users_file = tmp_path / "users.txt"
    users_file.write_text("\n".join(str(u) for u in (5, 17, 999999, 42, 1200, 7)))
    args = {"limit": ["--limit", "40", "--chunk", "16"],
            "city": ["--limit", "12", "--city", "Sochi", "--mode", "personal", "--lambda-param", "1.0",
                     "--chunk", "8"],
            "users": ["--users", str(users_file), "--chunk", "4"]}[case]
    common = ["--artifacts", str(ARTIFACT), "--data", str(DATA)]
    ours, theirs = tmp_path / "port.jsonl", tmp_path / "jax.jsonl"
    assert batch_cli.main([*common, "--out", str(ours), "--device", "cpu", *args]) == 0
    assert jax_batch_main([*common, "--out", str(theirs), *args]) == 0
    lines = [json.loads(line) for line in ours.read_text().splitlines()]
    assert lines == [json.loads(line) for line in theirs.read_text().splitlines()]
    assert len(lines) == {"limit": 40, "city": 12, "users": 5}[case]  # the unknown user has no home city
    mode = "personal" if case == "city" else "friends"
    lam = 1.0 if case == "city" else 0.7
    for rec in lines:
        online = engine.recommend(rec["user_id"], rec["city"], mode, lam)
        assert rec["hotels"] == online.get("ranked_hotels", []), rec["user_id"]
    assert any(rec["hotels"] for rec in lines)
