"""Readings that set the limits of ``correct``: for each seed, in one
process, a short run of a cell, the program's numbers against the
reference, and the same numbers of the control (the reference in the
nearest precision below the configuration's) and, for training, of the
planted faults: half of the batch left out, the mean over the rest (in the
reference); a step that leaves the state unchanged (it reads 1 on the
change gaps by construction); and, with ``--replay-faults``, a run of the
program under each fault of ``portbench/faults.py`` that only a graph
replay can have. The benchmark's own runs do not run this.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 3 --out build/calib.json
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench import run as bench  # noqa: E402  (sets the cache directories first)


def controls(cell, ctx: dict, device) -> dict:
    """The control's and the faults' numbers for a run's judged inputs."""
    from portbench import serve_ref, spec

    kind = spec.kind(cell.traffic["kind"])
    if cell.traffic["kind"] == "serve_bulk":
        refw, fit, flat, m, ref, requests, kept = ctx["judge_inputs"]
        return {"control": serve_ref.judge(refw, fit, flat, m, ref, requests, kept, control=ref.control_prec(m))}
    ref, cfg, reviews, flat, seed, epochs, ref_out = ctx["judge_inputs"]
    ctl = kind.reference_steps(ref, cfg, reviews, flat, seed, epochs, device, ref.control_prec(cfg["model"]))
    half = kind.reference_steps(ref, cfg, reviews, flat, seed, epochs, device, ref.reference_prec(cfg["model"]),
                                half_batch=True)
    still = kind.readings_of(ref_out, flat)
    for key in ("changes", "replay_changes"):
        still[key] = {k: 0.0 for k in still[key]}
    return {"control": kind.gaps(ref_out, flat, kind.readings_of(ctl, flat)),
            "half_batch": kind.gaps(ref_out, flat, kind.readings_of(half, flat)),
            "unchanged_state": kind.gaps(ref_out, flat, still)}


def replay_faults(name: str, seed: int, seconds: float, device) -> dict:
    """The program's numbers in a run of the cell under each replay fault."""
    from portbench import faults

    out = {}
    for what, plant in faults.REPLAY.items():
        try:
            with plant():
                _cell, ctx = bench.run_cell(name, seed, seconds, False, device)
        except Exception as e:  # a fault that crashes the run has failed it
            out[what] = {"error": f"{type(e).__name__}: {e}"[:400]}
            continue
        out[what] = ctx["numbers"]
        del ctx
        gc.collect()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out", required=True)
    p.add_argument("--replay-faults", default="", help="seeds (comma-separated) to run the replay faults on")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        cell, ctx = bench.run_cell(args.workload, seed, args.seconds, False, device)
        line = bench.result_line(cell, ctx, False, {"platform": "gpu"})
        rec = {"seed": seed, "program": ctx["numbers"], "metrics": line["metrics"], **controls(cell, ctx, device)}
        if str(seed) in args.replay_faults.split(","):
            rec.update(replay_faults(args.workload, seed, args.seconds, device))
        rows.append(rec)
        print(json.dumps(rec), flush=True)
        del ctx
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
