#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card: build, parity, serving.

Run from the repository root with no arguments::

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. needs ``torch.cuda.is_available()``; prints the card's name and power
   limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them;
2. builds ``hhrs_tpu_torch/csrc/tower_eval.cu`` with nvcc (sm_90a);
3. holds the fused tower kernel against its plain PyTorch version on the
   card with the hpo_r5 weights: B ∈ {128, 200, 8·128, 64·128}, both cross
   variants, and a tower without residual blocks, at rtol = atol = 2e-5;
4. builds ``RecommendationEngine.from_dirs("benchmarks/results/hpo_r5/best",
   "data")`` on cuda and serves the golden sweep (known, unknown and
   friendless users; every city and an unknown one; both modes; λ ∈
   {0.7, 1.0}), ``recommend_many`` with K = 8 and ``similar_items``; every
   response must equal ``hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json``,
   where two hotels may trade places only if their golden logits differ by
   less than ``SWAP_TOL``. The kernel's launch count is reset just before
   this phase and must be > 0 after it;
5. times the kernel, its plain version and the cuBLAS products of the same
   tower at B = 128 and 64·128 (CUDA events), per-request p50 of
   ``recommend`` and ``recommend_many`` (host clock, each ending in the
   device→host copy), and profiles 20 requests' device time (torch.profiler).

The last lines are one JSON object of kernel measurements, the nvidia-smi
line, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
ARTIFACT = "benchmarks/results/hpo_r5/best"
GOLDEN = "hhrs_tpu_torch/testdata/serve_golden_hpo_r5.json"
OUT_DIR = REPO / "chiprun_out"
SEED = 0
TOL = 2e-5  # kernel vs plain, rtol and atol: the JAX kernel's parity bar
SWAP_TOL = 1e-4  # golden logits of two hotels allowed to trade places
# H100 SXM published peaks (NVIDIA data sheet): f32 on CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "nvidia-smi unavailable"


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def tower_work(folded: dict, B: int) -> tuple[float, float]:
    """(flops, bytes) one call must do: each input read once, output written once."""
    d, H = folded["w0"].shape
    R, L = folded["w1"].shape[0], folded["cross_w"].shape[0]
    flops = 2.0 * B * (d * H + 2 * R * H * H + 3 * L * d + H + d)
    weights = sum(t.numel() for t in folded.values())
    return flops, 4.0 * (weights + B * d + B)


def time_cuda(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, after warm-up (CUDA events)."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare_response(got: dict, want: dict, logits: list) -> int | None:
    """Number of tie swaps, or None when ``got`` breaks the tie rule."""
    if set(got) != set(want) or got.get("message") != want.get("message"):
        return None
    g, w = got["ranked_hotels"], want["ranked_hotels"]
    if len(g) != len(w):
        return None
    logit = {h["hotel_id"]: x for h, x in zip(w, logits)}
    payload = {h["hotel_id"]: h for h in w}
    swaps = 0
    for gh, wh in zip(g, w):
        if gh.get("hotel_id") not in payload or gh != payload[gh["hotel_id"]]:
            return None
        if gh["hotel_id"] != wh["hotel_id"]:
            if abs(logit[gh["hotel_id"]] - logit[wh["hotel_id"]]) >= SWAP_TOL:
                return None
            swaps += 1
    return swaps


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is false: this smoke test needs a CUDA card")
    sys.path.insert(0, str(REPO))
    try:
        from hhrs_tpu_torch.models.convert import dcnr_from_jax
        from hhrs_tpu_torch.ops import cuda_build, tower
        from hhrs_tpu_torch.serve.engine import RecommendationEngine
        from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
    except ImportError as e:
        return fail(f"the hhrs_tpu_torch package is not beside this script: {e}")

    import numpy as np

    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    OUT_DIR.mkdir(exist_ok=True)

    # ---- phase 2: build -------------------------------------------------
    t0 = time.perf_counter()
    lib_path = cuda_build.build("tower_eval", ["tower_eval.cu"])
    print(f"[build] {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    print(lib_path.with_suffix(".log").read_text().strip() if lib_path.with_suffix(".log").exists()
          else "[build] reused an existing library")

    # ---- phase 3: kernel against its plain version ----------------------
    bundle = load_artifact_bundle(str(REPO / ARTIFACT))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, dev)
    folded = tower.fold_eval_params(model)
    no_res = dict(folded, w1=folded["w1"][:0].contiguous(), b1=folded["b1"][:0].contiguous(),
                  w2=folded["w2"][:0].contiguous(), b2=folded["b2"][:0].contiguous())
    gen = np.random.default_rng(SEED)

    def features(B: int):
        cats = [n for _, n in bundle.dims.cat_dims]
        with torch.no_grad():
            return tower.build_x0(
                model,
                torch.as_tensor(gen.integers(0, bundle.dims.n_users, B), device=dev),
                torch.as_tensor(gen.integers(0, bundle.dims.n_items, B), device=dev),
                torch.as_tensor(np.stack([gen.integers(0, n, B) for n in cats], 1), device=dev),
                torch.as_tensor(gen.random((B, bundle.dims.n_num_features), np.float32), device=dev),
            ).contiguous()

    max_err = 0.0
    launches_before = tower.tower_eval.launches
    n_checks = 0
    for B in (128, 200, 8 * 128, 64 * 128):
        x0 = features(B)
        for label, f in (("dcnr", folded), ("n_res=0", no_res)):
            for variant in ("code", "canonical"):
                with torch.no_grad():
                    out = tower.tower_eval(f, x0, variant)
                    ref = tower.tower_eval_ref(f, x0, variant)
                torch.cuda.synchronize()
                n_checks += 1
                err = (out - ref).abs()
                bad = int((err > TOL + TOL * ref.abs()).sum())
                max_err = max(max_err, float(err.max()))
                print(f"[parity] B={B} {label} {variant}: max|kernel-plain|={float(err.max()):.3e} "
                      f"outside tol={bad}")
                if bad or not torch.isfinite(out).all():
                    return fail(f"kernel disagrees with its plain version at B={B} {label} {variant}")
        # equal rows give equal logits wherever they sit in the batch
        with torch.no_grad():
            flipped = tower.tower_eval(folded, x0.flip(0).contiguous(), "code").flip(0)
            n_checks += 1
            if not torch.equal(flipped, tower.tower_eval(folded, x0, "code")):
                return fail(f"a row's logit depends on its position (B={B})")
            n_checks += 1
    if tower.tower_eval.launches - launches_before != n_checks:
        return fail("the launch counter did not count every parity launch")
    print(f"[parity] {n_checks} launches held to rtol=atol={TOL}; max abs err {max_err:.3e}")

    # ---- phase 4: the serving path --------------------------------------
    golden = json.loads((REPO / GOLDEN).read_text())
    tower.tower_eval.launches = 0
    t0 = time.perf_counter()
    engine = RecommendationEngine.from_dirs(str(REPO / ARTIFACT), str(REPO / "data"))
    build_s = time.perf_counter() - t0
    if engine.device.type != "cuda" or engine._folded is None:
        return fail("the engine is not serving dcnr through the tower kernel on cuda")
    swaps = 0
    for req, want, logits in zip(golden["requests"], golden["responses"], golden["logits"]):
        got = json.loads(json.dumps(engine.recommend(*req)))
        s = compare_response(got, want, logits)
        if s is None:
            return fail(f"recommend{tuple(req)} differs from the golden response")
        swaps += s
    many = [golden["requests"][i] for i in golden["many"]]
    for i, got in zip(golden["many"], engine.recommend_many(many)):
        s = compare_response(json.loads(json.dumps(got)), golden["responses"][i], golden["logits"][i])
        if s is None:
            return fail(f"recommend_many differs from the golden response {i}")
        swaps += s
    for item, n, want in golden["similar"]:
        if engine.similar_items(item, n) != want:
            return fail(f"similar_items({item}, {n}) differs from the golden answer")
    torch.cuda.synchronize()
    path_launches = tower.tower_eval.launches
    n_req = len(golden["requests"])
    print(f"[serve] engine built in {build_s:.2f} s; {n_req} recommend + 1 recommend_many(K={len(many)}) "
          f"+ {len(golden['similar'])} similar_items match the golden file; tie swaps: {swaps}")
    print(f"[serve] tower_eval launches on the serving path: {path_launches}")
    if path_launches <= 0:
        return fail("the serving path never launched the tower kernel")

    # ---- phase 5: timings -------------------------------------------------
    kernels = []
    rows = {}
    for B, iters in ((128, 500), (64 * 128, 50)):
        x0 = features(B)
        with torch.no_grad():
            ms = time_cuda(lambda: tower.tower_eval(folded, x0), iters)
            plain_ms = time_cuda(lambda: tower.tower_eval_ref(folded, x0), iters)

            def products():  # the tower's 1 + 2R matrix products alone, in cuBLAS
                deep = torch.addmm(folded["b0"], x0, folded["w0"])
                for r in range(folded["w1"].shape[0]):
                    h = torch.addmm(folded["b1"][r], deep, folded["w1"][r])
                    deep = torch.addmm(folded["b2"][r], h, folded["w2"][r])
                return deep

            library_ms = time_cuda(products, iters)
        flops, nbytes = tower_work(folded, B)
        t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
        rows[B] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_ops, t_bytes),
                       bound_by="operations" if t_ops >= t_bytes else "bytes")
        print(f"[time] tower B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS products "
              f"{library_ms:.4f} ms, bound {rows[B]['bound_ms']:.4f} ms ({rows[B]['bound_by']}; "
              f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.3f} MB) on {card}")

    reqs = golden["requests"]
    lat = []
    for i in range(3 * len(reqs) // 2):
        t0 = time.perf_counter()
        engine.recommend(*reqs[i % len(reqs)])
        lat.append(time.perf_counter() - t0)
    lat_many = []
    for i in range(30):
        batch = [reqs[(8 * i + j) % len(reqs)] for j in range(8)]
        t0 = time.perf_counter()
        engine.recommend_many(batch)
        lat_many.append(time.perf_counter() - t0)
    p50 = statistics.median(lat[10:]) * 1e3
    p50_many = statistics.median(lat_many[3:]) * 1e3
    print(f"[time] recommend p50 {p50:.3f} ms/request; recommend_many(K=8) p50 "
          f"{p50_many:.3f} ms/batch = {p50_many / 8:.3f} ms/request (host clock) on {card}")

    try:  # the profiler is a diagnostic, not a phase: its absence fails nothing
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for req in reqs[:20]:
                engine.recommend(*req)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        avg = prof.key_averages()
        self_dev = lambda e: getattr(e, "self_device_time_total", 0) or 0  # noqa: E731
        device_ms = sum(self_dev(e) for e in avg) / 1e3
        (OUT_DIR / "chip_smoke_profile.txt").write_text(
            avg.table(sort_by="self_device_time_total", row_limit=40)
        )
        print(f"[profile] 20 recommend calls: wall {wall_ms:.2f} ms, device busy {device_ms:.2f} ms "
              f"({100 * device_ms / wall_ms:.1f}% of wall, profiler on) on {card}")
        for e in sorted(avg, key=self_dev, reverse=True)[:8]:
            print(f"[profile]   {e.key[:70]:70s} self {self_dev(e) / 1e3:8.3f} ms calls {e.count}")
    except Exception as e:  # noqa: BLE001
        print(f"[profile] not measured: {type(e).__name__}: {e}")

    r = rows[128]
    kernels.append({
        "name": "tower_eval", "route": "cuda", "source": "hhrs_tpu_torch/csrc/tower_eval.cu",
        "replaces": "hhrs_tpu/ops/pallas/tower_kernel.py:133", "launches": path_launches,
        "max_abs_err": max_err, "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
    })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                               "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
