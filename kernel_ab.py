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
  ``cross_stack_backward``) on seeded normal x0 and dy, w and b drawn as
  the JAX init draws them, at B ∈ {1, 3, 5, 512, 1000, 4487, 8192}
  (prefixes of one batch), d ∈ {113, 33}, L ∈ {1, 3}, both variants: y,
  dx0, dw and db, each held to the tree's plain version at the term-scale
  bar, and a repeated backward held to the first bit for bit; timed at
  B = 512, 4487 and 8192 (d = 113, L = 3), and, where the tree has
  ``cross.plan_of``, at each alternative plan of tile rows, whose y and
  dx0 must equal the chosen plan's bit for bit.

Times are CUDA-event means and each kernel's device time per call from
torch.profiler (for the backward, every kernel of one call: one in a tree
with ``cross.plan_of``, a row kernel and a block-sum kernel before; the
profile must show no more than that many a call; "not measured" where the
profiler drops more than ``chip_smoke.device_ms_per_call`` allows).
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
CROSS_B = (1, 3, 5, 512, 1000, 4487, 8192)
CROSS_TIMED_B = ((512, 500), (4487, 300), (8192, 200))  # (B, calls), d = 113, L = 3


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
    """One seeded set of cross inputs per width: x0, dy [8192, d]; w, b [3, d]."""
    import numpy as np
    import torch

    gen = np.random.default_rng(chip_smoke.SEED + 3)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()  # noqa: E731
    inputs = {}
    for d in (113, 33):
        inputs[d] = dict(x0=f32(gen.standard_normal((max(CROSS_B), d))),
                         dy=f32(gen.standard_normal((max(CROSS_B), d))),
                         w=f32(gen.uniform(-1, 1, (3, d)) / np.sqrt(d)),
                         b=f32(0.1 * gen.standard_normal((3, d))))
    return inputs


def alternative_plans(cross, x0, backward: bool) -> dict:
    """The chosen plan first, then tiles of 8, 16 and 32 rows, each on as
    many blocks as the card runs at once."""
    chosen = cross.plan_of(x0, backward)
    plans = {f"chosen plan {tuple(chosen)}": chosen}
    cluster = cross.CLUSTER if backward else 1
    for rows in (8, 16, 32):
        tiles = -(-x0.shape[0] // rows)
        grid = -(-min(tiles, cross.capacity(x0, backward)) // cluster) * cluster
        plan = cross.CrossPlan(rows, grid, min(cross.MAX_STAGES, -(-tiles // grid)))
        if plan != chosen:
            plans[f"plan {tuple(plan)}"] = plan
    return plans


def cross_run(card: str, dev) -> dict:
    import torch

    from hhrs_tpu_torch.ops import cross

    inputs = cross_inputs(dev)
    outputs = {}
    worst_share = 0.0
    with torch.no_grad():
        for d, t in inputs.items():
            for B in CROSS_B:
                x0, dy = t["x0"][:B].contiguous(), t["dy"][:B].contiguous()
                for L in (1, 3):
                    w, b = t["w"][:L].contiguous(), t["b"][:L].contiguous()
                    for variant in ("code", "canonical"):
                        key = f"B={B} d={d} L={L} {variant}"
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
                            worst_share = max(worst_share, cross.assert_close_to_scale(
                                got, want, sc, **chip_smoke.CROSS_TOL, what=f"{name} at {key}")[1])
                        outputs[key] = [o.cpu() for o in (y, *grads)]
    print(f"[cross] {len(outputs)} cases held to their plain versions at rtol={chip_smoke.CROSS_TOL['rtol']} "
          f"atol={chip_smoke.CROSS_TOL['atol']} against the term scale (largest share of the allowance "
          f"{worst_share:.3f}); every repeated backward bit-identical", flush=True)

    times = []
    t = inputs[113]
    w, b = t["w"], t["b"]
    with torch.no_grad():
        for B, calls in CROSS_TIMED_B:
            x0, dy = t["x0"][:B].contiguous(), t["dy"][:B].contiguous()
            for kind, name in (("fwd", "cross_fwd"), ("bwd", "cross_bwd")):
                def call(plan=None):
                    if kind == "fwd":
                        return cross.cross_stack_forward(w, b, x0, "code", **({} if plan is None else {"plan": plan}))
                    return cross.cross_stack_backward(w, b, x0, dy, "code", **({} if plan is None else {"plan": plan}))

                plans = {"chosen plan": None}
                one_launch = hasattr(cross, "plan_of")  # else the backward is a row and a block-sum kernel
                launches = 1 if kind == "fwd" or one_launch else 2
                if one_launch:
                    plans = alternative_plans(cross, x0, kind == "bwd")
                    want = call() if kind == "fwd" else call()[0]
                    for what, plan in plans.items():
                        got = call(plan) if kind == "fwd" else call(plan)[0]
                        if not torch.equal(got, want):
                            raise SystemExit(f"kernel_ab: cross {kind} at B={B} under {what} differs from the "
                                             "chosen plan's output")
                for what, plan in plans.items():
                    ms = chip_smoke.time_cuda(lambda: call(plan), calls)
                    device_ms = chip_smoke.device_ms_per_call(lambda: call(plan), 50, name, launches)
                    times.append(dict(B=B, kind=kind, what=what, ms=ms, device_ms=device_ms, kernels=launches))
                    print(f"[time] cross {kind} B={B} {what}: {ms:.4f} ms (device {chip_smoke.ms_text(device_ms, 1e3, 2)} us, "
                          f"{launches} kernels a call) on {card}", flush=True)
    return dict(outputs=outputs, times=times)


def run(tree: Path, out: Path) -> None:
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
    result = dict(tree=str(tree), card=card, cross=cross_run(card, dev), **tower_run(tree, card, dev))
    torch.save(result, out)
    print(f"[ab] {tree}: {len(result['logits'])} logit vectors, {len(result['cross']['outputs'])} cross cases and "
          f"{len(result['times']) + len(result['cross']['times'])} times written to {out}")


def compare(a_path: Path, b_path: Path) -> int:
    import torch

    a, b = torch.load(a_path), torch.load(b_path)
    print(f"[ab] A = {a['tree']} ({a['card']}); B = {b['tree']} ({b['card']})")
    if not torch.equal(a["x0"], b["x0"]):
        print("[ab] the two runs scored different inputs: no comparison")
        return 1
    n_equal, worst = 0, 0.0
    for key in a["logits"]:
        x, y = a["logits"][key], b["logits"][key]
        same, delta = torch.equal(x, y), float((x - y).abs().max())
        n_equal += same
        worst = max(worst, delta)
        print(f"[identity] tower {key}: bitwise equal {'yes' if same else 'no'}, max|Δ| {delta:.3e}")
    print(f"[identity] tower: {n_equal} of {len(a['logits'])} cases bitwise equal; max|Δ| {worst:.3e}")

    n_cross, worst_sums = 0, 0.0
    for key, (ya, dxa, dwa, dba) in a["cross"]["outputs"].items():
        yb, dxb, dwb, dbb = b["cross"]["outputs"][key]
        same = torch.equal(ya, yb) and torch.equal(dxa, dxb)
        n_cross += same
        delta = max(float((dwa - dwb).abs().max()), float((dba - dbb).abs().max()))
        worst_sums = max(worst_sums, delta)
        print(f"[identity] cross {key}: y and dx0 bitwise equal {'yes' if same else 'no'} (max|Δ| y "
              f"{float((ya - yb).abs().max()):.3e}, dx0 {float((dxa - dxb).abs().max()):.3e}); "
              f"dw/db max|Δ| {delta:.3e}")
    n_cases = len(a["cross"]["outputs"])
    print(f"[identity] cross: y and dx0 bitwise equal in {n_cross} of {n_cases} cases; dw/db max|Δ| "
          f"{worst_sums:.3e} (each run holds dw/db to its plain version at the term-scale bar)")
    for run, label in ((a, "A"), (b, "B")):
        for t in run["times"]:
            print(f"[time] {label} tower B={t['B']} {t['what']}: {t['ms']:.4f} ms (device {chip_smoke.ms_text(t['device_ms'])} ms)")
        for t in run["cross"]["times"]:
            print(f"[time] {label} cross {t['kind']} B={t['B']} {t['what']}: {t['ms']:.4f} ms "
                  f"(device {chip_smoke.ms_text(t['device_ms'], 1e3, 2)} us, {t['kernels']:g} kernels a call)")
    return 0 if n_equal == len(a["logits"]) and n_cross == n_cases else 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="root of the tree whose hhrs_tpu_torch runs")
    parser.add_argument("--out", type=Path, help="file for this run's outputs and times")
    parser.add_argument("--compare", nargs=2, type=Path, metavar=("A", "B"), help="compare two runs' files")
    args = parser.parse_args()
    if args.compare:
        return compare(*args.compare)
    if args.out is None:
        parser.error("--out or --compare is needed")
    run(args.tree.resolve(), args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
