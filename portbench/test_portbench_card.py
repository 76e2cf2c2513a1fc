"""Card tests of the benchmark's comparison: at each cell's own size, on
three seeds, the control (the reference in the nearest precision below the
configuration's) and, for training, the planted half-batch fault and each
fault that only a graph replay can have (``portbench/faults.py``, planted
in the program) must each fail one of the cell's numbers, while the
program passes them all. Marked ``cuda``; they skip without a card.

    python -m pytest --noconftest -p no:cacheprovider -m cuda portbench/test_portbench_card.py
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import calibrate, faults, run as bench, spec  # noqa: E402

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def fails(numbers: dict, limits: dict) -> bool:
    return not bench.passed(bench.checks_of(numbers, limits))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_and_the_faults_fail_at_the_cells_size(name, card):
    for seed in SEEDS:
        cell, ctx = bench.run_cell(name, seed, 3.0, False, card)
        assert not fails(ctx["numbers"], cell.limits), (seed, ctx["numbers"])
        for what, numbers in calibrate.controls(cell, ctx, card).items():
            assert fails(numbers, cell.limits), (seed, what, numbers)


TRAIN_CELLS = [n for n in CELLS if spec.cell(n).traffic["kind"] == "train"]


@pytest.mark.cuda
@pytest.mark.parametrize("fault", sorted(faults.REPLAY))
@pytest.mark.parametrize("name", TRAIN_CELLS)
def test_a_fault_of_the_graph_replay_makes_the_run_incorrect(name, fault, card):
    for seed in SEEDS:
        with faults.REPLAY[fault]():
            cell, ctx = bench.run_cell(name, seed, 3.0, False, card)
        assert fails(ctx["numbers"], cell.limits), (seed, ctx["numbers"])
