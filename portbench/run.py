"""The benchmark of the PyTorch and CUDA port (``hhrs_tpu_torch``): one run
of one cell.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic, limits, metrics and kind of job are
found by name (``portbench/spec.py``). The run needs a CUDA card and exits
non-zero without one. It prints, as the last line of its standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared with the reference beside its limit, which are also the
last lines of its standard error. Builds and kernel caches stay in
``build/`` inside the checkout.
"""

from __future__ import annotations

import os
import sys
import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


AGE0 = _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "portbench")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv_compute_cache"), ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "kernels")):
    os.environ[_var] = os.path.join(CACHE, _sub)
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "hhrs_tpu"}


def clock() -> float:
    """Seconds since the process started."""
    return AGE0 + time.perf_counter() - T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def checks_of(numbers: dict, limits: dict) -> dict:
    return {name: {"value": numbers[name], "limit": lim} for name, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def result_line(cell, ctx: dict, trace: bool, device_info: dict) -> dict:
    """The run's readings → the result object (``checks`` last)."""
    from portbench import spec

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = checks_of(ctx["numbers"], cell.limits)
    device = dict(device_info, memory_peak_bytes=int(ctx["memory_peak_bytes"]))
    out = {"correct": passed(checks), "attempted": int(ctx["attempted"]), "failed": int(ctx["failed"]),
           "metrics": metrics, "device": device}
    tr = ctx.get("trace")
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = checks
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, device) -> tuple:
    """One run of a cell on ``device`` → (the cell, the readings)."""
    from portbench import spec

    cell = spec.cell(name)
    kind = spec.kind(cell.traffic["kind"])
    marks = [("card context", clock())]
    ctx = kind.run(cell, seed, seconds, trace, device, clock)
    ctx["setup_marks"] = marks + ctx["setup_marks"] + [("set-up", ctx["setup_s"])]
    return cell, ctx


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import spec

    chips = next((w["chips"] for w in spec.manifest()["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.zeros(1, device=device)  # the card's context, made before the cell's clock marks
    cell, ctx = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), device)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark measures the PyTorch port only", file=sys.stderr)
        return 3
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    out = result_line(cell, ctx, bool(args.trace), info)
    extra = {k: v for k, v in ctx["numbers"].items() if k not in out["checks"]}
    print("set-up, seconds since the process started: "
          + ", ".join(f"{what} {t:.3f}" for what, t in ctx["setup_marks"]), file=sys.stderr)
    print(f"readings not held to a limit: {json.dumps(extra)}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
