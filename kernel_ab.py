#!/usr/bin/env python3
"""The CUDA kernels of two trees of the port, side by side on one CUDA card.

A run feeds one set of seeded inputs to one tree's ``hhrs_tpu_torch`` and
keeps its outputs and times in a file; ``--compare`` reads two such files and
says whether the outputs are bitwise equal and how the times differ::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 kernel_ab.py --tree build/parent --out build/ab_parent.pt
    python3 kernel_ab.py --out build/ab_change.pt
    python3 kernel_ab.py --compare build/ab_parent.pt build/ab_change.pt

(``build/`` is not committed, so an earlier tree unpacked there travels with
a copy of the working tree but not with a checkout.) A run calls only the
entry points that every tree of the port with both kernels has:

* the fused tower kernel (``tower.tower_eval``, and ``tower.launch`` where
  the tree has it), on the inputs of ``chip_smoke.py``'s phase 3: the
  hpo_r5 weights, ``build_x0`` of seeded random ids, prefixes of one
  8192-row batch, both cross variants, with and without residual blocks;
  timed at B = 128, 1024, 2048, 4096 and 8192, for ``tower_eval`` and for
  every launch plan ``tower.launch`` takes;
* the cross-stack kernels (``cross.cross_stack_forward`` and
  ``cross_stack_backward``), float32 and bfloat16, on seeded normal x0 and
  dy, w and b drawn as the JAX init draws them, at B ∈ {1, 3, 5, 512, 1000,
  4487, 8192, 32768} (prefixes of one batch; bf16 at B ∈ {1, 5, 9, 512,
  4487, 8192, 32768}), d ∈ {113, 33} with L ∈ {1, 3}, and d = 145 with L ∈
  {1, 6} (w at a quarter of the bound, as phase 11a draws it), both
  variants: y, dx0, dw and db, each held to the tree's plain version at the
  term-scale bar (bf16: entries outside ``CROSS_BF16_TOL`` are counted and
  printed, not refused: a bf16 gate that rounds the other way moves a row by
  2⁻⁷·|g|·|x0|, past that bar where |g| > 1/2, in the parent as well), and a
  repeated backward held to the first bit for bit; timed at B = 512, 4487,
  8192 and 32768, both dtypes, at d = 113, L = 3 and at d = 145, L = 6
  (``CROSS_TIMED_SHAPES``), and, where the tree has ``cross.plan_of``, at
  each alternative plan of tile rows, whose y and dx0 must equal the chosen
  plan's bit for bit; both kernels also at d = 113, L = 1 and 6 (B = 8192,
  float32), which shows how their time follows the row's chain of L or 2L
  reductions;
* the trial-axis kernels (``cross.cross_stack_forward_trials`` and
  ``cross_stack_backward_trials``, where the tree has them) at K = 8, 16 and
  64 (``TRIAL_KS``) on ``chip_smoke.py``'s phase 11a shapes, both dtypes:
  the backward under the tree's own plan, the single-trial plan of B rows
  and the trial plan in clusters of 8 (the single-trial plan over capacity
  // K blocks in whole clusters, computed here from ``cross.capacity`` and
  ``cross.cross_plan``, so any tree with a trial axis takes it through
  ``plan=``) and, in a tree with clusters of 2, the same in clusters of 2:
  dx0 under every plan, and dw / db under each named plan, kept for the
  comparison; the forward under the tree's own plan, the single-trial plan
  and the forward trial plan (the single-trial plan over capacity // K
  forward blocks, computed here the same way) and that plan's tiles of 16
  and 32 rows: y under every plan, which must be the tree's own plan's bit
  for bit; each plan timed with its waves;
* the tree's cross library as built: ptxas's registers and spills for each
  kernel instance and, where the toolkit has ``cuobjdump``, the static SASS
  instruction counts of each forward and backward instance by kind
  (conversions, shuffles, f32 and bf16x2 arithmetic, shared-memory loads).

Times are CUDA-event means and each kernel's device time per call from
torch.profiler (for the backward, every kernel of one call: one in a tree
with ``cross.plan_of``, a row kernel and a block-sum kernel before; the
profile must show no more than that many a call; "not measured" where the
profiler drops more than ``chip_smoke.device_ms_per_call`` allows). Row
outputs (y, dx0) are kept as digests of their bytes (and whole up to 8192
rows); dw and db whole.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import chip_smoke  # before --tree goes on sys.path: an earlier tree has its own

REPO = Path(__file__).resolve().parent
PARITY_B = (1, 31, 33, 128, 200, 1000, 1024, 8192)
TIMED_B = ((128, 500), (1024, 200), (2048, 100), (4096, 100), (8192, 50))  # (B, calls)
KERNEL = "tower_eval_kernel"
CROSS_B = (1, 3, 5, 512, 1000, 4487, 8192, 32768)
CROSS_BF16_B = (1, 5, 9, 512, 4487, 8192, 32768)  # bf16 rows are bulk-copied 8 at a time
CROSS_WIDE_B = (5, 512, 4096)  # d = 145 with L = 1 and 6
CROSS_TIMED_B = ((512, 500), (4487, 300), (8192, 200), (32768, 100))  # (B, calls)
CROSS_TIMED_SHAPES = ((113, 3), (145, 6))  # (d, L): the hpo_r5 stack and the search space's widest
LAYERS_TIMED = ((1, 200), (6, 200))  # (L, calls): both float32 kernels at d = 113, B = 8192 beside L = 3
# the trial-axis kernels' group sizes: phase 11a's K = 8, and 16 and 64,
# where the backward's trial plan chooses between clusters of 8 and 2 (K =
# 64 is past the capacity of one cluster of 8 a trial at d = 113)
TRIAL_KS = (8, 16, 64)
# (B, d, L, w bound, calls): chip_smoke.py's TRIAL_SHAPES, phase 11a's shapes
TRIAL_CASES = ((512, 113, 3, 1.0, 300), (4096, 145, 6, 0.25, 100))
WHOLE_ROWS = 8192  # row outputs of at most this many rows are kept whole beside their digest


def tower_run(tree: Path, card: str, dev) -> dict:
    import numpy as np
    import torch

    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle

    bundle = load_artifact_bundle(str(tree / chip_smoke.ARTIFACT))
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, dev)
    folded = tower.fold_eval_params(model)
    no_res = dict(folded, **{k: folded[k][:0].contiguous() for k in ("w1", "b1", "w2", "b2")})
    gen = np.random.default_rng(chip_smoke.SEED)
    B = max(PARITY_B)
    cats = [n for _, n in bundle.dims.cat_dims]
    with torch.no_grad():
        x0_all = tower.build_x0(
            model,
            torch.as_tensor(gen.integers(0, bundle.dims.n_users, B), device=dev),
            torch.as_tensor(gen.integers(0, bundle.dims.n_items, B), device=dev),
            torch.as_tensor(np.stack([gen.integers(0, n, B) for n in cats], 1), device=dev),
            torch.as_tensor(gen.random((B, bundle.dims.n_num_features), np.float32), device=dev),
        ).contiguous()
        logits = {}
        for b in PARITY_B:
            for label, f in (("dcnr", folded), ("n_res=0", no_res)):
                for variant in ("code", "canonical"):
                    logit = tower.tower_eval(f, x0_all[:b].contiguous(), variant)
                    logits[f"B={b} {label} {variant}"] = logit.cpu()

        times = []
        for b, calls in TIMED_B:
            x0 = x0_all[:b].contiguous()
            fns = {"tower_eval": lambda: tower.tower_eval(folded, x0)}
            if hasattr(tower, "plan_of"):
                fns[f"tower_eval, plan {tower.plan_of(folded, x0)}"] = fns.pop("tower_eval")
            if hasattr(tower, "launch"):
                for rows in tower.TILE_ROWS:
                    for cluster in tower.CLUSTER_SIZES:
                        plan = (rows, cluster)
                        try:
                            tower.launch(folded, x0, "code", plan)
                        except ValueError:  # a plan this kernel does not take
                            continue
                        fns[f"plan {plan}"] = lambda plan=plan: tower.launch(folded, x0, "code", plan)
            for what, fn in fns.items():
                ms = chip_smoke.time_cuda(fn, calls)
                device_ms = chip_smoke.device_ms_per_call(fn, 50, KERNEL)
                times.append(dict(B=b, what=what, ms=ms, device_ms=device_ms))
                print(f"[time] tower B={b} {what}: {ms:.4f} ms (device {chip_smoke.ms_text(device_ms)} ms) on {card}", flush=True)
    return dict(x0=x0_all.cpu(), logits=logits, times=times)


def cross_inputs(dev) -> dict:
    """One seeded set of cross inputs per width: x0, dy [32768, d]; w, b
    [L, d] for the most layers a width takes (d = 145 at a quarter of the
    JAX init's bound, as phase 11a draws its 6-layer shape)."""
    import numpy as np
    import torch

    gen = np.random.default_rng(chip_smoke.SEED + 3)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    inputs = {}
    for d, L, bound in ((113, 3, 1.0), (33, 3, 1.0), (145, 6, 0.25)):
        inputs[d] = dict(x0=f32(gen.standard_normal((max(CROSS_B), d))),
                         dy=f32(gen.standard_normal((max(CROSS_B), d))),
                         w=f32(gen.uniform(-bound, bound, (L, d)) / np.sqrt(d)),
                         b=f32(0.1 * gen.standard_normal((L, d))))
    return inputs


def digest(t) -> str:
    """The bytes of a tensor, as a hex digest: equal digests, equal bits."""
    import hashlib

    import torch

    return hashlib.sha256(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes()).hexdigest()


def kept(t) -> dict:
    """A row output as a run keeps it: its digest, and itself up to WHOLE_ROWS rows."""
    return {"digest": digest(t), "whole": t.cpu() if t.shape[-2] <= WHOLE_ROWS else None}


def alternative_plans(cross, x0, backward: bool) -> dict:
    """The chosen plan first, then tiles of 8, 16 and 32 rows, each on as
    many blocks as the card runs at once."""
    chosen = cross.plan_of(x0, backward)
    plans = {f"chosen plan {tuple(chosen)}": chosen}
    cluster = cross.CLUSTER if backward else 1
    align = getattr(cross, "ROW_ALIGN", {}).get(x0.dtype, 4)
    for rows in (8, 16, 32):
        if rows % align:
            continue
        tiles = -(-x0.shape[0] // rows)
        grid = -(-min(tiles, cross.capacity(x0, backward)) // cluster) * cluster
        plan = cross.CrossPlan(rows, grid, min(cross.MAX_STAGES, -(-tiles // grid)))
        if plan != chosen:
            plans[f"plan {tuple(plan)}"] = plan
    return plans


def cross_cases():
    """(dtype name, d, B, L) of every parity case."""
    for dtype, Bs in (("float32", CROSS_B), ("bfloat16", CROSS_BF16_B)):
        for d, Ls in ((113, (1, 3)), (33, (1, 3))):
            for B in Bs:
                for L in Ls:
                    yield dtype, d, B, L
        for B in CROSS_WIDE_B:
            for L in (1, 6):
                yield dtype, 145, B, L


def cross_run(card: str, dev) -> dict:
    import torch

    from hhrs_tpu_torch.ops import cross

    inputs = cross_inputs(dev)
    outputs = {}
    worst_share = {"float32": 0.0, "bfloat16": 0.0}
    outside = []  # bf16 entries outside CROSS_BF16_TOL, reported
    tol = {"float32": chip_smoke.CROSS_TOL, "bfloat16": chip_smoke.CROSS_BF16_TOL}
    with torch.no_grad():
        for dtype, d, B, L in cross_cases():
            t = inputs[d]
            cast = (lambda a: a.to(torch.bfloat16).contiguous()) if dtype == "bfloat16" else (lambda a: a)
            x0, dy = cast(t["x0"][:B].contiguous()), cast(t["dy"][:B].contiguous())
            w, b = cast(t["w"][:L].contiguous()), cast(t["b"][:L].contiguous())
            for variant in ("code", "canonical"):
                key = f"{dtype} B={B} d={d} L={L} {variant}"
                y = cross.cross_stack_forward(w, b, x0, variant)
                grads = cross.cross_stack_backward(w, b, x0, dy, variant)
                again = cross.cross_stack_backward(w, b, x0, dy, variant)
                torch.cuda.synchronize()
                if not all(torch.equal(a, c) for a, c in zip(grads, again)):
                    raise SystemExit(f"kernel_ab: a repeated cross backward differs at {key}")
                ref = (cross.cross_stack_apply(w, b, x0, variant),
                       *cross.cross_stack_backward_ref(w, b, x0, dy, variant))
                scale = cross.cross_stack_term_scale(w, b, x0, dy, variant)
                for name, got, want, sc in zip(("y", "dx0", "dw", "db"), (y, *grads), ref, scale):
                    share = plain_share(got, want, sc, tol[dtype])
                    worst_share[dtype] = max(worst_share[dtype], float(share.max()) if share.numel() else 0.0)
                    n_out = int((share > 1).sum())
                    if n_out and dtype == "float32":
                        raise SystemExit(f"kernel_ab: {name} at {key}: {n_out} entries outside {tol[dtype]}")
                    if n_out:
                        outside.append(f"{name} at {key}: {n_out} of {share.numel()} (largest share "
                                       f"{float(share.max()):.2f})")
                outputs[key] = {"y": kept(y), "dx0": kept(grads[0]), "dw": grads[1].cpu(), "db": grads[2].cpu()}
    for dtype, share in worst_share.items():
        print(f"[cross] {dtype}: cases against their plain versions at {tol[dtype]} against the term scale "
              f"(largest share of the allowance {share:.3f}); every repeated backward bit-identical", flush=True)
    for line in outside:
        print(f"[cross] bfloat16 outside CROSS_BF16_TOL: {line}", flush=True)
    print(f"[cross] {len(outputs)} cases", flush=True)

    times = []
    with torch.no_grad():
        timed = [(dtype, d, L, B, calls) for dtype in ("float32", "bfloat16") for d, L in CROSS_TIMED_SHAPES
                 for B, calls in CROSS_TIMED_B]
        timed += [("float32", 113, L, 8192, calls) for L, calls in LAYERS_TIMED]
        for dtype, d, L, B, calls in timed:
            t = inputs[d]
            cast = (lambda a: a.to(torch.bfloat16).contiguous()) if dtype == "bfloat16" else (lambda a: a)
            x0, dy = cast(t["x0"][:B].contiguous()), cast(t["dy"][:B].contiguous())
            if L <= t["w"].shape[0]:
                w, b = cast(t["w"][:L].contiguous()), cast(t["b"][:L].contiguous())
            else:  # 6 layers of d = 113 at a quarter of the bound, as for d = 145
                w = cast(inputs[145]["w"][:L, :113].contiguous() * (145 / 113) ** 0.5)
                b = cast(inputs[145]["b"][:L, :113].contiguous())
            for kind, name in (("fwd", "cross_fwd"), ("bwd", "cross_bwd")):

                def call(plan=None):
                    extra = {} if plan is None else {"plan": plan}
                    if kind == "fwd":
                        return cross.cross_stack_forward(w, b, x0, "code", **extra)
                    return cross.cross_stack_backward(w, b, x0, dy, "code", **extra)

                plans = {"chosen plan": None}
                one_launch = hasattr(cross, "plan_of")  # else the backward is a row and a block-sum kernel
                launches = 1 if kind == "fwd" or one_launch else 2
                if one_launch:
                    plans = alternative_plans(cross, x0, kind == "bwd")
                    want = call() if kind == "fwd" else call()[0]
                    for what, plan in plans.items():
                        got = call(plan) if kind == "fwd" else call(plan)[0]
                        if not torch.equal(got, want):
                            raise SystemExit(f"kernel_ab: cross {dtype} {kind} at B={B} d={d} L={L} under {what} "
                                             "differs from the chosen plan's output")
                for what, plan in plans.items():
                    ms = chip_smoke.time_cuda(lambda: call(plan), calls)
                    device_ms = chip_smoke.device_ms_per_call(lambda: call(plan), 50, name, launches)
                    times.append(dict(dtype=dtype, B=B, d=d, L=L, kind=kind, what=what, ms=ms,
                                      device_ms=device_ms, kernels=launches))
                    print(f"[time] cross {dtype} {kind} B={B} d={d} L={L} {what}: {ms:.4f} ms (device "
                          f"{chip_smoke.ms_text(device_ms, 1e3, 2)} us, {launches} kernels a call) on {card}",
                          flush=True)
    return dict(outputs=outputs, times=times)


def plain_share(got, want, scale, tol: dict):
    """|got − want| / (atol + rtol · scale), entry by entry (0 where both are equal)."""
    import torch

    err = (got.double() - want.double()).abs()
    return torch.where(err == 0, 0.0, err / (tol["atol"] + tol["rtol"] * scale))


def trial_plan(cross, x0, K: int):
    """The single-trial plan of x0's B rows over capacity // K blocks of the
    backward, rounded down to whole clusters of 8 (at least one): the K grids
    then fit the card together (a tree may choose smaller clusters for its
    own trial plan)."""
    cap = cross.capacity(x0, True)
    per_trial = max(cross.CLUSTER, cap // K // cross.CLUSTER * cross.CLUSTER)
    return cross.cross_plan(x0.shape[0], per_trial, cross.CLUSTER, cross.ROW_ALIGN[x0.dtype])


def fwd_trial_plans(cross, x0, K: int) -> dict:
    """The forward's plans of K trials of x0's B rows besides the tree's own
    and the single-trial one: the single-trial plan over capacity // K
    forward blocks (at least one; the forward has no clusters), which puts
    the K grids on the card in one wave, and the same blocks with tiles of
    16 and 32 rows."""
    B, align = x0.shape[0], cross.ROW_ALIGN[x0.dtype]
    per_trial = max(1, cross.capacity(x0, False) // K)
    plan = cross.cross_plan(B, per_trial, 1, align)
    plans = {"forward trial plan": plan}
    for rows in (16, 32):
        tiles = -(-B // rows)
        grid = min(tiles, per_trial)
        other = cross.CrossPlan(rows, grid, min(cross.MAX_STAGES, cross.MAX_RING // rows, -(-tiles // grid)))
        if other != plan:
            plans[f"forward trial plan, tiles of {rows}"] = other
    return plans


def trial_run(card: str, dev) -> dict:
    """The trial-axis kernels at each K of TRIAL_KS: the backward under the
    tree's plan, the single-trial plan and the trial plans, the forward under
    the tree's plan, the single-trial plan and the forward trial plans:
    outputs and device times."""
    import numpy as np
    import torch

    from hhrs_tpu_torch.ops import cross

    if not hasattr(cross, "cross_stack_backward_trials"):
        print("[trials] this tree has no trial-axis kernels", flush=True)
        return dict(outputs={}, times=[])
    gen = np.random.default_rng(chip_smoke.SEED + 12)
    outputs, times = {}, []

    def timed(kind: str, fn, key: str, shown, held: int, calls: int, row: dict) -> None:
        ms = chip_smoke.time_cuda(fn, calls)
        device_ms = chip_smoke.device_ms_per_call(fn, 50, f"cross_{kind}")
        waves = -(-row["K"] * shown.grid // held)
        times.append(dict(row, kind=kind, plan=tuple(shown), waves=waves, ms=ms, device_ms=device_ms))
        print(f"[time] trial-axis cross {kind} {key.removeprefix('fwd ')} {tuple(shown)} ({waves} waves of {held} "
              f"blocks): {ms:.4f} ms (device {chip_smoke.ms_text(device_ms, 1e3, 2)} us) on {card}", flush=True)

    with torch.no_grad():
        for (B, d, L, bound, calls), K in ((case, K) for K in TRIAL_KS for case in TRIAL_CASES):
            f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
            x0, dy = f32(gen.standard_normal((K, B, d))), f32(gen.standard_normal((K, B, d)))
            w = f32(gen.uniform(-bound, bound, (K, L, d)) / np.sqrt(d))
            b = f32(0.1 * gen.standard_normal((K, L, d)))
            for dtype in ("float32", "bfloat16"):
                cast = (lambda a: a.to(torch.bfloat16).contiguous()) if dtype == "bfloat16" else (lambda a: a)
                args = [cast(a) for a in (w, b, x0, dy)]
                plans = {"tree's plan": None, "single-trial plan": cross.plan_of(args[2][0], True),
                         "trial plan in clusters of 8": trial_plan(cross, args[2][0], K)}
                if 2 in getattr(cross, "CLUSTER_SIZES", ()):  # a tree whose backward has clusters of 2
                    per_trial = max(2, cross.capacity(args[2][0], True, 2) // K // 2 * 2)
                    plans["trial plan in clusters of 2"] = cross.cross_plan(
                        B, per_trial, 2, cross.ROW_ALIGN[args[2].dtype])._replace(cluster=2)
                cap = cross.capacity(args[2][0], True)
                for what, plan in plans.items():
                    extra = {} if plan is None else {"plan": plan}
                    fn = lambda extra=extra: cross.cross_stack_backward_trials(*args, "code", **extra)  # noqa: E731
                    dx0, dw, db = fn()
                    again = fn()
                    torch.cuda.synchronize()
                    if not all(torch.equal(p, q) for p, q in zip((dx0, dw, db), again)):
                        raise SystemExit(f"kernel_ab: a repeated trial-axis backward differs at B={B} {what}")
                    key = f"{dtype} K={K} B={B} d={d} L={L} {what}"
                    outputs[key] = {"dx0": kept(dx0), "dw": dw.cpu(), "db": db.cpu()}
                    own = cross.trial_plan_of(args[2]) if hasattr(cross, "trial_plan_of") else plans["single-trial plan"]
                    shown = plan or own
                    cluster = getattr(shown, "cluster", cross.CLUSTER)
                    held = cap if cluster == cross.CLUSTER else cross.capacity(args[2][0], True, cluster)
                    timed("bwd", fn, key, shown, held, calls, dict(dtype=dtype, K=K, B=B, d=d, L=L, what=what))

                single = cross.plan_of(args[2][0], False)
                plans = {"tree's plan": None, "single-trial plan": single, **fwd_trial_plans(cross, args[2][0], K)}
                own = cross.fwd_trial_plan_of(args[2]) if hasattr(cross, "fwd_trial_plan_of") else single
                held, want = cross.capacity(args[2][0], False), None
                for what, plan in plans.items():
                    extra = {} if plan is None else {"plan": plan}
                    fn = lambda extra=extra: cross.cross_stack_forward_trials(*args[:3], "code", **extra)  # noqa: E731
                    y = fn()
                    torch.cuda.synchronize()
                    want = y if want is None else want
                    if not torch.equal(y, want):
                        raise SystemExit(f"kernel_ab: the trial-axis forward at {dtype} K={K} B={B} under {what} "
                                         "differs from the tree's plan's y")
                    key = f"fwd {dtype} K={K} B={B} d={d} L={L} {what}"
                    outputs[key] = {"y": kept(y)}
                    timed("fwd", fn, key, plan or own, held, calls, dict(dtype=dtype, K=K, B=B, d=d, L=L, what=what))
    return dict(outputs=outputs, times=times)


SASS_KINDS = {  # SASS opcode prefixes counted by kind
    "bf16 convert": ("F2F", "F2FP"), "shuffle": ("SHFL",), "f32 arith": ("FFMA", "FADD", "FMUL"),
    "bf16x2 arith": ("HFMA2", "HADD2", "HMUL2"), "prmt/shift": ("PRMT", "SHF", "IMAD.U32"),
    "shared load": ("LDS",), "shared store": ("STS",),
}


def library_summary(tree: Path) -> dict:
    """The tree's cross library as built: ptxas's (kernel, registers, spill
    bytes), and the static SASS instruction counts of each forward and
    backward instance by kind where the toolkit has cuobjdump."""
    import re
    import shutil
    import subprocess

    from hhrs_tpu_torch.ops import cross, cuda_build

    cross._kernels()  # builds the library if this process has not
    lib = cuda_build.library_path("cross_stack", ["cross_stack.cu"])
    log = lib.with_suffix(".log")
    regs = chip_smoke.ptxas_summary(log.read_text()) if log.exists() else []
    for kernel, n, spills in regs:
        print(f"[build] {tree.name}: {kernel}: {n} registers, {spills} bytes spilled", flush=True)
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    counts = {}
    try:
        sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
    except OSError:
        sass = ""
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cross_kernel = re.search(r"cross_(fwd|fwd_direct|bwd)_kernel", m.group(1))
            name = chip_smoke.demangled(m.group(1)) if cross_kernel else None
            if name:
                counts[name] = dict.fromkeys(["total", *SASS_KINDS], 0)
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", line)
        if name and m:
            op = m.group(1)
            counts[name]["total"] += 1
            if op.startswith("HFMA2.MMA"):  # a register move, not arithmetic
                continue
            for kind, prefixes in SASS_KINDS.items():
                if op.startswith(prefixes):
                    counts[name][kind] += 1
    for kernel, c in counts.items():
        print(f"[sass] {tree.name}: {kernel}: " + ", ".join(f"{k} {v}" for k, v in c.items()), flush=True)
    if not sass:
        print("[sass] cuobjdump not found or empty: no instruction counts", flush=True)
    return dict(registers=regs, sass=counts)


def run(tree: Path, out: Path, parts: str) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA card")
    sys.path.insert(0, str(tree))
    from hhrs_tpu_torch.ops import cross, tower

    for mod in (cross, tower):
        if Path(mod.__file__).resolve().parents[2] != tree:
            raise SystemExit(f"kernel_ab: imported {mod.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
    result = dict(tree=str(tree), card=card, parts=parts, library=library_summary(tree),
                  cross=cross_run(card, dev) if "cross" in parts else dict(outputs={}, times=[]),
                  trials=trial_run(card, dev))
    result.update(tower_run(tree, card, dev) if "tower" in parts else dict(x0=None, logits={}, times=[]))
    torch.save(result, out)
    print(f"[ab] {tree}: {len(result['logits'])} logit vectors, {len(result['cross']['outputs'])} cross cases, "
          f"{len(result['trials']['outputs'])} trial-axis cases and "
          f"{len(result['times']) + len(result['cross']['times']) + len(result['trials']['times'])} times written "
          f"to {out}")


def _row_delta(a: dict, b: dict) -> str:
    if a["whole"] is None or b["whole"] is None:
        return "not kept"
    return f"{float((a['whole'].float() - b['whole'].float()).abs().max()):.3e}"


def _sums_delta(a: dict, b: dict) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in ("dw", "db"))


def compare(a_path: Path, b_path: Path) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    print(f"[ab] A = {a['tree']} ({a['card']}); B = {b['tree']} ({b['card']})")
    n_equal = 0
    if a["logits"] and b["logits"]:
        if not torch.equal(a["x0"], b["x0"]):
            print("[ab] the two runs scored different inputs: no comparison")
            return 1
        worst = 0.0
        for key in a["logits"]:
            x, y = a["logits"][key], b["logits"][key]
            same, delta = torch.equal(x, y), float((x - y).abs().max())
            n_equal += same
            worst = max(worst, delta)
            print(f"[identity] tower {key}: bitwise equal {'yes' if same else 'no'}, max|Δ| {delta:.3e}")
        print(f"[identity] tower: {n_equal} of {len(a['logits'])} cases bitwise equal; max|Δ| {worst:.3e}")

    n_cross, n_sums, worst_sums = 0, 0, {"float32": 0.0, "bfloat16": 0.0}
    for key, oa in a["cross"]["outputs"].items():
        ob = b["cross"]["outputs"][key]
        same = all(oa[k]["digest"] == ob[k]["digest"] for k in ("y", "dx0"))
        n_cross += same
        delta = _sums_delta(oa, ob)
        n_sums += delta == 0 and all(torch.equal(oa[k], ob[k]) for k in ("dw", "db"))
        dtype = key.split()[0]
        worst_sums[dtype] = max(worst_sums[dtype], delta)
        print(f"[identity] cross {key}: y and dx0 bitwise equal {'yes' if same else 'no'} (max|Δ| y "
              f"{_row_delta(oa['y'], ob['y'])}, dx0 {_row_delta(oa['dx0'], ob['dx0'])}); dw/db max|Δ| {delta:.3e}")
    n_cases = len(a["cross"]["outputs"])
    print(f"[identity] cross: y and dx0 bitwise equal in {n_cross} of {n_cases} cases; dw/db bitwise equal in "
          f"{n_sums} of {n_cases} (same inputs, each tree's plan_of); dw/db max|Δ| f32 {worst_sums['float32']:.3e}, "
          f"bf16 {worst_sums['bfloat16']:.3e}")

    n_trial, n_trial_sums, n_fwd, trial_keys = 0, 0, 0, [k for k in a["trials"]["outputs"]
                                                           if k in b["trials"]["outputs"]]
    for key in trial_keys:
        oa, ob = a["trials"]["outputs"][key], b["trials"]["outputs"][key]
        if "y" in oa:  # a forward case
            same = oa["y"]["digest"] == ob["y"]["digest"]
            n_trial += same
            n_fwd += 1
            print(f"[identity] trial-axis {key}: y bitwise equal {'yes' if same else 'no'} (max|Δ| "
                  f"{_row_delta(oa['y'], ob['y'])})")
            continue
        same = oa["dx0"]["digest"] == ob["dx0"]["digest"]
        n_trial += same
        delta = _sums_delta(oa, ob)
        n_trial_sums += delta == 0
        print(f"[identity] trial-axis {key}: dx0 bitwise equal {'yes' if same else 'no'}; dw/db max|Δ| {delta:.3e}")
    print(f"[identity] trial-axis: y (forward, {n_fwd} cases) and dx0 (backward, {len(trial_keys) - n_fwd} cases) "
          f"bitwise equal in {n_trial} of {len(trial_keys)} cases, dw/db in {n_trial_sums} (equal only under the "
          "same plan)")

    for run, label in ((a, "A"), (b, "B")):
        for t in run["times"]:
            print(f"[time] {label} tower B={t['B']} {t['what']}: {t['ms']:.4f} ms (device {chip_smoke.ms_text(t['device_ms'])} ms)")
        for t in run["cross"]["times"]:
            print(f"[time] {label} cross {t.get('dtype', 'float32')} {t['kind']} B={t['B']} d={t.get('d', 113)} "
                  f"L={t.get('L', 3)} {t['what']}: {t['ms']:.4f} ms (device {chip_smoke.ms_text(t['device_ms'], 1e3, 2)} us, "
                  f"{t['kernels']:g} kernels a call)")
        for t in run["trials"]["times"]:
            print(f"[time] {label} trial-axis {t.get('kind', 'bwd')} {t['dtype']} K={t['K']} B={t['B']} "
                  f"d={t['d']} L={t['L']} {t['what']} {t['plan']} ({t['waves']} waves): {t['ms']:.4f} ms "
                  f"(device {chip_smoke.ms_text(t['device_ms'], 1e3, 2)} us)")
    tower_ok = n_equal == len(a["logits"])
    return 0 if tower_ok and n_cross == n_cases and n_trial == len(trial_keys) else 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="root of the tree whose hhrs_tpu_torch runs")
    parser.add_argument("--out", type=Path, help="file for this run's outputs and times")
    parser.add_argument("--compare", nargs=2, type=Path, metavar=("A", "B"), help="compare two runs' files")
    parser.add_argument("--parts", default="tower,cross",
                        help="'tower,cross' (default), 'cross' (the cross and trial-axis cases alone) or "
                             "'trials' (the trial-axis forward and backward cases alone)")
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.out is None:
        parser.error("--out or --compare is needed")
    run(args.tree.resolve(), args.out, args.parts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
