"""CPU tests of the benchmark harness: the manifest and its names, every
cell's files, the counters, the import rule, and each cell end to end at a
tiny size on the CPU (the program's plain kernels), with the program
correct and with faults planted under the timed path.

    python -m pytest portbench/test_portbench_cpu.py -q
"""

from __future__ import annotations

import ast
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(ROOT))

from portbench import run as bench  # noqa: E402
from portbench import spec, work  # noqa: E402

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_manifest_parses_with_its_keys():
    assert set(MANIFEST) == TOP
    assert MANIFEST["command"] == ["python3", "portbench/run.py"]
    assert MANIFEST["paths"] == ["portbench"]
    assert 1 <= MANIFEST["run_seconds"] <= 51 and isinstance(MANIFEST["run_seconds"], int)
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for e in MANIFEST["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace") and 0.01 <= e["bound"] <= 0.25
    for p in MANIFEST["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines_are_allowed():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MANIFEST[group]:
            assert spec.NAME.match(entry["name"]), entry["name"]
            names.append((group, entry["name"]))
            for key in ("why", "layer", "source"):
                if key in entry:
                    assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert spec.UNIT.match(entry["unit"]), entry["unit"]
            if "better" in entry:
                assert entry["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    for w in MANIFEST["workloads"]:
        assert spec.NAME.match(w["config"]) and spec.NAME.match(w["traffic"])
    for c in MANIFEST["configs"]:
        assert len(c["reduced"]) <= 16 and all(spec.NAME.match(k) for k in c["reduced"])
        assert PATH_RE.match(c["file"]) and c["file"].startswith("portbench/")
    metric_names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in metric_names
    for p in MANIFEST["per_layer"]:
        assert p["moves"] in metric_names
    layers = {}
    for p in MANIFEST["per_layer"]:
        layers.setdefault(p["layer"], set()).add(p["name"])
    assert all(len(layer.splitlines()) == 1 for layer in layers)


def test_file_names_under_paths_use_name_characters():
    for f in HERE.rglob("*"):
        if "__pycache__" in f.parts or f.is_dir():
            continue
        rel = f.relative_to(ROOT).as_posix()
        assert PATH_RE.match(rel), rel


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    cell = spec.cell(name)
    assert spec.kind(cell.traffic["kind"]).run
    assert spec.reference(cell.config).tower
    assert cell.limits and all(isinstance(v, (int, float)) for v in cell.limits.values())
    assert any(e["name"] == "setup_s" for e in cell.end_to_end) and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m["name"]))
    c = next(c for c in MANIFEST["configs"] if c["name"] == cell.workload["config"])
    assert json.loads((ROOT / c["file"]).read_text())["model"]


def test_every_config_and_metric_is_used():
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_tower_counter_on_known_shapes():
    flops, nbytes = work.tower_work(B=1000, d=113, H=320, R=3, L=3)
    assert flops == 2.0 * 1000 * (113 * 320 + 2 * 3 * 320 * 320 + 3 * 3 * 113 + 320 + 113)
    weights = 113 * 320 + 320 + 2 * 3 * (320 * 320 + 320) + 2 * 3 * 113 + (320 + 113) + 1
    assert nbytes == 4.0 * (weights + 1000 * 113 + 1000)
    assert work.least_s(flops, nbytes) == max(flops / 67e12, nbytes / 3.35e12)


def test_cross_counter_on_known_shapes():
    assert work.cross_work(512, 113, 3, "fwd") == (5.0 * 512 * 3 * 113, 4 * (2 * 512 * 113 + 2 * 3 * 113))
    assert work.cross_work(512, 49, 2, "bwd", elem=2) == (13.0 * 512 * 2 * 49, 2 * (3 * 512 * 49 + 4 * 2 * 49))
    assert work.least_s(1e9, 0, "bfloat16") == 1e9 / 989e12


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_under_the_harness_imports_jax_or_the_jax_package():
    found = set()
    for f in HERE.rglob("*.py"):
        found |= _imports(f)
    assert not found & bench.FORBIDDEN, found & bench.FORBIDDEN
    assert "hhrs_tpu_torch" in found  # the port, whose name starts with the JAX package's


def test_the_loaded_module_check_compares_whole_names(monkeypatch):
    before = bench.forbidden_modules()
    monkeypatch.setitem(sys.modules, "hhrs_tpu_torch_probe.x", sys)
    assert bench.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert "jaxlib" in bench.forbidden_modules()


def test_a_run_without_a_card_fails_and_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert bench.main(["--workload", CELLS[0], "--seed", "3000000001", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "5",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode != 0 and not proc.stdout.strip()


# --- each cell end to end on the CPU at a tiny size ----------------------

TINY = {
    "metro": {"world": {"n_users": 3000, "n_items": 800, "n_reviews": 30000, "n_friendships": 9000,
                        "n_cities": 8}, "batch": 16, "warm_batches": 2, "sample_every": 1},
    "tuned": {"world": {"n_users": 2000, "n_items": 400, "n_reviews": 30000, "n_friendships": 600,
                        "n_cities": 6}},
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.traffic = {**cell.traffic, **TINY[cell.workload["traffic"]]}
    if cell.config["train"]["batch_size"] > 2048:
        cell.config = {**cell.config, "train": {**cell.config["train"], "batch_size": 2048}}
    return cell


def run_tiny(name: str, seed: int = 3000000007, trace: bool = False) -> dict:
    cell = tiny_cell(name)
    ctx = spec.kind(cell.traffic["kind"]).run(cell, seed, 1.0, trace, torch.device("cpu"), bench.clock)
    return bench.result_line(cell, ctx, trace, {"platform": "cpu", "kind": "cpu", "count": 1})


@pytest.mark.parametrize("name", CELLS)
def test_the_port_agrees_with_the_reference_at_a_tiny_size(name):
    out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks" and out["attempted"] > 0
    names = {m["name"] for m in spec.cell(name).end_to_end}
    assert set(out["metrics"]) == names
    assert all(math.isfinite(v["value"]) and v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_run_reads_the_host_metrics(name):
    out = run_tiny(name, trace=True)
    assert out["correct"] and "breakdown" in out
    assert out["device"]["window_s"] > 0
    host = {m["name"] for m in spec.cell(name).per_layer if m["source"] == "host_clock"}
    assert host <= set(out["metrics"])


def _answer_altered(monkeypatch):
    from hhrs_tpu_torch.serve import engine

    assemble = engine.RecommendationEngine._assemble

    def altered(self, user_id, lam, packed):
        out = assemble(self, user_id, lam, packed)
        out["ranked_hotels"] = out["ranked_hotels"][::-1]
        return out
    monkeypatch.setattr(engine.RecommendationEngine, "_assemble", altered)


def _half_batch_served(monkeypatch):
    from hhrs_tpu_torch.serve import engine

    device_rank = engine.RecommendationEngine._device_rank

    def half(self, inputs, capped=False):
        n = inputs.shape[0] // 2
        return device_rank(self, torch.cat([inputs[:n], inputs[:n]])[:inputs.shape[0]], capped)
    monkeypatch.setattr(engine.RecommendationEngine, "_device_rank", half)


def _state_unchanged(monkeypatch):
    from hhrs_tpu_torch.train import trainer

    make = trainer.make_train_optimizer

    def frozen(*a, **k):
        opt = make(*a, **k)
        opt.step = lambda *_a, **_k: None
        return opt
    monkeypatch.setattr(trainer, "make_train_optimizer", frozen)


def _half_batch_trained(monkeypatch):
    from hhrs_tpu_torch.train import trainer

    bce = trainer.bce_with_logits
    monkeypatch.setattr(trainer, "bce_with_logits", lambda l, y: bce(l[:len(l) // 2], y[:len(y) // 2]))


FAULTS = {"serve_bulk": [_answer_altered, _half_batch_served], "train": [_state_unchanged, _half_batch_trained]}


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS
                                        for f in FAULTS[spec.cell(n).traffic["kind"]]],
                         ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_fault_under_the_timed_path_makes_the_run_incorrect(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_tiny(name)
    assert out["correct"] is False, out["checks"]
