#!/usr/bin/env python3
"""Where a mesh engine's request time goes, on one CUDA card.

    python3 mesh_profile.py [--tree DIR] [--label NAME] [--out FILE] [--parts 13a,13c]

Two of ``chip_smoke.py``'s phase-13 worlds, profiled:

* 13a: a world of one rank on NCCL in this process. ``recommend`` (the
  graphed one-request bucket) over the golden sweep, in turns, on three
  engines: the single-device engine as served (city-bounded), the
  single-device engine over every item (``city_bounded=False``: the rows a
  mesh engine ranks) and the 1-rank mesh engine. Their responses must be
  equal. Then the host-clock p50 of each, and one torch.profiler trace of
  each over ``PROFILED`` requests;
* 13c: a gloo world of 3 ranks sharing the card on the tuned preset's data
  (4,000 items, a seeded random model at hpo_r5's widths, as phase 13c
  builds it): the host-clock p50 of one-request batches, each rank's host
  time inside each collective (waiting for the other ranks included) and
  in its batch, and a torch.profiler trace of rank 0.

A trace's device events (kernels and copies) are split by request (each
launch maps to the request whose range holds it) and, within a request, at
its scoring launches (the tower kernel, or the cross forward): "before"
(the candidate masks and x0's gathers), "scoring" (first to last scoring
launch), and "after" (the stable order, MMR, the packed output), with
sorts apart. Collectives (NCCL kernels) and copies are named by kind. The
device's busy time per request beside the host time gives its idle share.

``--tree DIR`` imports ``hhrs_tpu_torch`` from another tree (unpacked with
``git archive``; its kernels build there, or are copied into its
``build/``); ``--out`` keeps the readings as JSON. Compare two trees in one
call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import bisect
import json
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import chip_smoke  # before --tree goes on sys.path

PROFILED = 16  # requests in each trace
PADDED_REQUESTS = 48  # 13c's timed one-request batches
REQUEST_RANGE = "mesh_profile.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SCORING = ("tower_eval_kernel", "cross_fwd")


# ---- a trace, by request and by segment ----------------------------------- #


def _by_request(trace: Path) -> list:
    """Device events of each ``REQUEST_RANGE`` of a chrome trace, in order."""
    events = json.loads(trace.read_text())["traceEvents"]
    ranges = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") == REQUEST_RANGE)
    starts = [a for a, _ in ranges]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    per = [[] for _ in ranges]
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        t = launched.get(e.get("args", {}).get("correlation"))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= ranges[i][1]:
            per[i].append(e)
    return [sorted(p, key=lambda e: e["ts"]) for p in per]


def _segments(events: list) -> dict:
    """µs of one request's device events by segment, and its busy time."""
    out = defaultdict(float)
    scoring = [i for i, e in enumerate(events) if any(s in e["name"] for s in SCORING)]
    first, last = (scoring[0], scoring[-1]) if scoring else (len(events), len(events))
    for i, e in enumerate(events):
        name = e["name"]
        if "nccl" in name.lower() or "onerank" in name.lower():
            op = next((o for o in ("AllGather", "AllReduce", "Broadcast") if o in name), "other")
            key = f"nccl {op}"
            out[f"nccl {op} count"] += 1
        elif e["cat"] != "kernel":
            key = "copy " + next((k for k in ("HtoD", "DtoH", "DtoD") if k in name), "other")
        elif first <= i <= last:
            key = "scoring"
        elif i < first:
            key = "before scoring (candidates, x0)"
        elif "sort" in name.lower():
            key = "after: sorts"
        else:
            key = "after: MMR, order, pack"
        out[key] += e["dur"]
    busy, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda e: e["ts"]):  # the union of the events' intervals
        a, b = e["ts"], e["ts"] + e["dur"]
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    out["busy"] = busy
    out["scoring launches"] = len(scoring)
    return out


def _profile(call, reqs: list, tmp: str, name: str) -> dict:
    """One torch.profiler trace of ``call(r)`` for each request → the mean
    µs per request of each segment, the host ms, the requests seen."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in reqs:
            t = time.perf_counter()
            with record_function(REQUEST_RANGE):
                call(r)
            host.append(time.perf_counter() - t)
        torch.cuda.synchronize()
    path = Path(tmp) / f"{name}.json"
    prof.export_chrome_trace(str(path))
    per = [_segments(p) for p in _by_request(path) if p]
    keys = sorted({k for p in per for k in p})
    summary = {k: sum(p.get(k, 0.0) for p in per) / max(1, len(per)) for k in keys}
    summary.update(requests_seen=len(per), requests=len(reqs), host_ms_profiled=statistics.mean(host) * 1e3)
    return summary


def _print(label: str, what: str, s: dict, card: str) -> None:
    parts = ", ".join(f"{k} {v:.1f}" for k, v in s.items()
                      if k not in ("requests_seen", "requests", "host_ms_profiled"))
    print(f"[{label}] {what}: device µs a request ({s['requests_seen']} of {s['requests']} requests in the "
          f"trace): {parts}; host {s['host_ms_profiled']:.3f} ms a request under the profiler; idle share "
          f"{1 - s.get('busy', 0.0) / 1e3 / s['host_ms_profiled']:.3f} on {card}", flush=True)


# ---- 13a: one NCCL rank ----------------------------------------------------- #


def part_13a(label: str, card: str) -> dict:
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.parallel.distributed import init_world
    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    dev = torch.device("cuda")
    golden = json.loads((chip_smoke.REPO / chip_smoke.GOLDEN).read_text())
    reqs = golden["requests"]
    art, data = str(chip_smoke.REPO / chip_smoke.ARTIFACT), str(chip_smoke.REPO / "data")
    engines = {"single": RecommendationEngine.from_dirs(art, data, device=dev),
               "single_full": RecommendationEngine.from_dirs(art, data, device=dev, city_bounded=False)}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_world(0, 1, f"file://{tmp}/store", dev)
        try:
            engines["mesh"] = RecommendationEngine.from_dirs(art, data, device=dev, mesh=make_mesh(1, 1, dev))
            out["backend"], out["graphs"] = dist.get_backend(), engines["mesh"].graphs
            answers = {k: [e.recommend(*r) for r in reqs] for k, e in engines.items()}  # captures bucket 1
            out["equal"] = answers["mesh"] == answers["single"] == answers["single_full"]
            if not out["equal"]:
                raise SystemExit(f"[{label}] 13a: the engines' responses differ")
            p50 = defaultdict(list)
            for name in ("single", "single_full", "mesh", "mesh", "single_full", "single"):
                lat = []
                for r in reqs:
                    t = time.perf_counter()
                    engines[name].recommend(*r)
                    lat.append(time.perf_counter() - t)
                p50[name].append(statistics.median(lat) * 1e3)
            out["p50_ms"] = dict(p50)
            print(f"[{label}] 13a ({out['backend']}, {'graphed' if out['graphs'] else 'eager'}): recommend p50 "
                  f"over {len(reqs)} requests, in turns: " + "; ".join(
                      f"{k} {', '.join(f'{x:.3f}' for x in v)} ms" for k, v in p50.items()) + f" on {card}",
                  flush=True)
            out["profile"] = {}
            for name, e in engines.items():
                out["profile"][name] = s = _profile(lambda r: e.recommend(*r), reqs[:PROFILED], tmp, name)
                _print(label, f"13a {name}", s, card)
            engines["mesh"].close()
        finally:
            dist.destroy_process_group()
    return out


# ---- 13c: three gloo ranks on one card --------------------------------------- #


def padded_rank(spec: dict) -> dict | None:
    """A rank of 13c's world: every rank times its collectives and batches
    (host clock); rank 0 serves the requests, then a profiled few."""
    import torch
    import torch.distributed as dist

    from hhrs_tpu_torch.parallel.mesh import make_mesh
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    rank = dist.get_rank()
    eng = RecommendationEngine.from_dirs(spec["artifacts"], spec["data"], device=dev, mesh=make_mesh(-1, 1, dev))
    batches = []  # per batch: {"s": wall, op: [count, s]}
    active = [False]  # inside a batch: a follower's wait for the next header is not counted

    def timed(op, fn):
        def wrapped(*a, **k):
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if active[0]:
                    c = batches[-1].setdefault(op, [0, 0.0])
                    c[0] += 1
                    c[1] += time.perf_counter() - t
        return wrapped

    batch_fn = eng._mesh_batch

    def batch(*a, **k):
        batches.append({})
        active[0] = True
        t = time.perf_counter()
        try:
            return batch_fn(*a, **k)
        finally:
            batches[-1]["s"] = time.perf_counter() - t
            active[0] = False

    originals = {n: getattr(dist, n) for n in ("all_gather_into_tensor", "all_reduce", "broadcast")}
    for n, fn in originals.items():
        setattr(dist, n, timed(n, fn))
    eng._mesh_batch = batch
    answers = None
    try:
        if rank == 0:
            try:
                reqs = spec["requests"]
                for r in reqs[:3]:
                    eng.recommend(*r)
                wall, got = [], []
                for r in reqs[3:]:
                    t = time.perf_counter()
                    got.append(eng.recommend(*r))
                    wall.append(time.perf_counter() - t)
                with tempfile.TemporaryDirectory() as tmp:
                    prof = _profile(lambda r: eng.recommend(*r), reqs[3:3 + PROFILED], tmp, "padded")
                answers = {"wall_s": wall, "got": got, "profile": prof}
            finally:
                eng.shutdown()
        else:
            eng.follow()
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
    timed_batches = batches[3:3 + spec["timed"]]  # the timed requests' batches (warm-up and profiled left out)
    mine = {"rank": rank, "batch_ms": statistics.median(b["s"] for b in timed_batches) * 1e3,
            "collectives": {op: [sum(b.get(op, [0, 0.0])[0] for b in timed_batches) / len(timed_batches),
                                 sum(b.get(op, [0, 0.0])[1] for b in timed_batches) / len(timed_batches) * 1e3]
                            for op in originals}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    if rank == 0:
        answers["ranks"] = every
        return answers
    return None


def part_13c(label: str, card: str) -> dict:
    import numpy as np
    import torch

    from hhrs_tpu_torch.parallel.distributed import launch
    from hhrs_tpu_torch.serve.engine import RecommendationEngine

    dev = torch.device("cuda")
    chip_smoke.PHASE13_DIR.mkdir(parents=True, exist_ok=True)
    artifacts, data = chip_smoke._tuned_artifact(dev)
    single = RecommendationEngine.from_dirs(artifacts, data, device=dev, city_bounded=False)
    uni = single.gen.universe
    rng = np.random.default_rng(chip_smoke.SEED + 13)
    n = 3 + PADDED_REQUESTS
    reqs = [[int(rng.choice(uni.user_ids)), uni.cities[int(rng.integers(len(uni.cities)))],
             ("friends", "personal")[i % 2], (0.7, 1.0)[(i // 2) % 2]] for i in range(n)]
    spec = {"artifacts": artifacts, "data": data, "requests": reqs, "timed": PADDED_REQUESTS}
    out = launch(padded_rank, 3, (spec,), device=dev, timeout_s=600, store_dir=str(chip_smoke.PHASE13_DIR))
    want = [json.loads(json.dumps(single.recommend(*r))) for r in reqs[3:]]
    equal = sum(json.loads(json.dumps(g)) == w for g, w in zip(out["got"], want))
    p50 = statistics.median(out["wall_s"]) * 1e3
    print(f"[{label}] 13c: 3 gloo ranks share the card, {uni.n_items} items; one-request p50 {p50:.3f} ms "
          f"(host clock; {equal} of {len(want)} responses equal the single-device engine's) on {card}", flush=True)
    for r in out["ranks"]:
        print(f"[{label}] 13c rank {r['rank']}: batch p50 {r['batch_ms']:.3f} ms; collectives a batch (count, "
              "host ms, waiting included): " + ", ".join(f"{op} {c:.1f} / {ms:.3f}" for op, (c, ms)
                                                        in r["collectives"].items()), flush=True)
    _print(label, "13c rank 0", out["profile"], card)
    return {"p50_ms": p50, "equal": equal, "requests": len(want), "ranks": out["ranks"], "profile": out["profile"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import hhrs_tpu_torch from this tree")
    ap.add_argument("--label", default="profile")
    ap.add_argument("--out", default=None, help="write the readings as JSON here")
    ap.add_argument("--parts", default="13a,13c", help="the worlds to profile, comma-separated")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("mesh_profile.py needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.tree).resolve() if args.tree else chip_smoke.REPO))
    import hhrs_tpu_torch

    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"[{args.label}] hhrs_tpu_torch from {Path(hhrs_tpu_torch.__file__).parent}; card: {card}", flush=True)
    parts = {"13a": part_13a, "13c": part_13c}
    out = {"label": args.label, "card": card,
           **{name: parts[name](args.label, card) for name in args.parts.split(",")}}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
