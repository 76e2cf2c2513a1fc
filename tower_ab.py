#!/usr/bin/env python3
"""The fused tower kernel of two trees of the port, side by side on one CUDA card.

A run scores one set of inputs with one tree's ``hhrs_tpu_torch`` and keeps
its logits and times in a file; ``--compare`` reads two such files and says
whether the logits are bitwise equal and how the times differ::

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    python3 tower_ab.py --tree build/parent --out chiprun_out/ab_parent.pt
    python3 tower_ab.py --out chiprun_out/ab_change.pt
    python3 tower_ab.py --compare chiprun_out/ab_parent.pt chiprun_out/ab_change.pt

(``build/`` is not committed, so an earlier tree unpacked there travels with
a copy of the working tree but not with a checkout.) A run calls only
``tower.tower_eval``, and ``tower.launch`` where the tree has it, so it
takes any tree of the port. The inputs are those of ``chip_smoke.py``'s
phase 3: the hpo_r5 weights, ``build_x0`` of seeded random ids, prefixes of
one 8192-row batch, both cross variants, with and without residual blocks.
The times, at B = 128, 1024, 2048, 4096 and 8192, are CUDA-event means and
the kernel's device time per call from torch.profiler: for ``tower_eval``,
and for every launch plan ``tower.launch`` takes.
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


def run(tree: Path, out: Path) -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("tower_ab: needs a CUDA card")
    sys.path.insert(0, str(tree))
    from hhrs_tpu_torch.models.convert import dcnr_from_jax
    from hhrs_tpu_torch.ops import tower
    from hhrs_tpu_torch.train.artifacts import load_artifact_bundle

    if Path(tower.__file__).resolve().parents[2] != tree:
        raise SystemExit(f"tower_ab: imported {tower.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = chip_smoke.card_line()
    dev = torch.device("cuda")
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
                print(f"[time] B={b} {what}: {ms:.4f} ms (device {device_ms:.4f} ms) on {card}", flush=True)
    torch.save(dict(tree=str(tree), card=card, x0=x0_all.cpu(), logits=logits, times=times), out)
    print(f"[ab] {tree}: {len(logits)} logit vectors and {len(times)} times written to {out}")


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
        print(f"[identity] {key}: bitwise equal {'yes' if same else 'no'}, max|Δ| {delta:.3e}")
    print(f"[identity] {n_equal} of {len(a['logits'])} cases bitwise equal; max|Δ| {worst:.3e}")
    for run, label in ((a, "A"), (b, "B")):
        for t in run["times"]:
            print(f"[time] {label} B={t['B']} {t['what']}: {t['ms']:.4f} ms (device {t['device_ms']:.4f} ms)")
    return 0 if n_equal == len(a["logits"]) else 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=REPO, help="root of the tree whose hhrs_tpu_torch runs")
    parser.add_argument("--out", type=Path, help="file for this run's logits and times")
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
