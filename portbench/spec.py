"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout, and under this folder one file for each configuration
(``configs/<config>.json``), traffic mix (``traffic/<traffic>.json``), cell's
limits (``limits/<workload>.json``), per-layer or end-to-end metric
(``metrics/<metric>.py``) and kind of job (``cells/<kind>.py``, named by the
traffic file). A later cell or metric is added as files and entries."""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    m = manifest(root)
    w = next((w for w in m["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    c = next(c for c in m["configs"] if c["name"] == w["config"])
    config = load_json(root / c["file"])
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{name}.json")
    return Cell(name, w, config, traffic, limits,
                [e for e in m["end_to_end"] if reports(e, name)],
                [p for p in m["per_layer"] if reports(p, name)])


def module(path: Path, name: str):
    """Import a file by its path (names may hold dots), once."""
    key = "portbench._by_name." + name.replace(".", "_").replace("-", "_") + "_" + path.parent.name
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def reader(metric: str):
    return module(HERE / "metrics" / f"{metric}.py", metric).read


def kind(name: str):
    return module(HERE / "cells" / f"{name}.py", name)


def reference(config: dict):
    return module(HERE / "configs" / f"{config['reference']}.py", config["reference"])
