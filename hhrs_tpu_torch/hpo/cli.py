"""HPO sweep entry point: ``python -m hhrs_tpu_torch.hpo.cli``.

Counterpart of ``hhrs_tpu/hpo/cli.py``, with its flags plus ``--device``:
load-or-create a resumable study, optimize val LogLoss over the reference
search space with per-epoch pruning, record val AUC per trial, and export
serve artifacts whenever a trial improves on the best value (so a killed
sweep always leaves the best-so-far model on disk)::

    python -m hhrs_tpu_torch.hpo.cli --data data --trials 16 --vectorize 8 \\
        --epochs 2 --out OUT --journal OUT/j.jsonl [--reclaim-lanes] [--device cpu]

Trials train one at a time through ``train/trainer.py::train_dcn``, or with
``--vectorize K`` K at a time through ``hpo/vectorized.py::run_group``. The
device defaults to ``cuda`` and the sweep fails without a card.

``--mesh DATAxMODEL`` trains each trial over a mesh (``train_dcn``'s
``mesh``, with ``mesh.explicit_exchange`` and
``mesh.exchange_capacity_factor``); ``--vectorize-shard`` splits each
group's trial axis over the world's ranks (``run_group(shard_lanes=True)``;
a group whose size is not a multiple of the ranks runs unsharded, logged,
as in JAX). Either joins the world the environment configures, or else
launches one here, as ``train/cli.py`` does: ``DATA·MODEL`` ranks for
``--mesh``, one a card for ``--vectorize-shard`` (in this process when that
is one, or on the CPU). Every rank runs the whole study: every rank gets
the same val losses, so the sampler, the pruner, the plateaus and early
stops decide the same on each. Rank 0 alone writes the journal, the best
artifact (every rank joins ``export_artifacts``, which writes on rank 0) and
the plots; the other ranks load the journal when they start and keep the
study's state in memory from then on.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import sys

import torch.distributed as dist

from hhrs_tpu_torch.config import ModelConfig, TrainConfig, build_config
from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.hpo.space import reference_search_space
from hhrs_tpu_torch.hpo.study import TrialPruned, create_study
from hhrs_tpu_torch.utils.logging import setup_logging

log = logging.getLogger("hhrs_tpu_torch.hpo")


def model_cfg_from_params(params: dict, base: ModelConfig | None = None) -> ModelConfig:
    """Sampled hyperparams overlaid on the base config — every non-swept
    field (arch, cross_variant, bn_*, compute_dtype, …) passes through, so
    CLI overrides apply inside trials too."""
    base = base or ModelConfig()
    return dataclasses.replace(
        base,
        emb_dim=int(params["emb_dim"]),
        hidden_dim=int(params["hidden_dim"]),
        n_cross_layers=int(params["n_cross_layers"]),
        n_res_blocks=int(params["n_res_blocks"]),
        dropout=float(params["dropout"]),
    )


def train_cfg_from_params(params: dict, base: TrainConfig | None = None) -> TrainConfig:
    base = base or TrainConfig()
    return dataclasses.replace(
        base,
        lr=float(params["lr"]),
        batch_size=int(params["batch_size"]),
        weight_decay=float(params["weight_decay"]),
        optimizer=str(params["optimizer"]),
        lr_plateau_patience=int(params["lr_plateau_patience"]),
        lr_plateau_factor=float(params["lr_plateau_factor"]),
    )


def _export_best(args, params, bn_state, mcfg, dims, preproc, metrics, number: int) -> None:
    from hhrs_tpu_torch.train.artifacts import export_artifacts

    try:
        export_artifacts(args.out, params, bn_state, mcfg, dims, preproc, metrics)
    except Exception:  # noqa: BLE001 — the TRIAL succeeded; an export IO
        # failure must not journal a completed trial as 'failed'
        log.exception("best-artifact export failed (trial %d)", number)


def _optimize_vectorized(args, cfg, splits, dims, preproc, space, study, best_box):
    """ask K → group by architecture → one K-lane program per group → tell.

    Same per-trial semantics as the sequential objective (plateau, early
    stop, pruning, best-artifact export); the only difference is that
    same-shape trials share one program (hpo/vectorized.py)."""
    from hhrs_tpu_torch.hpo.vectorized import ARCH_KEYS, group_trials, lane_world, run_group

    def make_report(trial):
        def report_fn(epoch: int, val_loss: float) -> bool:
            trial.report(val_loss, epoch)
            return trial.should_prune()

        return report_fn

    shared = () if args.vectorize_independent else ARCH_KEYS
    asked_total = len(study.trials)  # resumed journals count toward the budget
    while asked_total < args.trials:
        k = min(args.vectorize, args.trials - asked_total)
        asked = study.ask(space, k, shared=shared)
        asked_total += k
        groups = group_trials([t.params for t in asked])
        log.info("vectorized round: %d trials → %d group(s) of sizes %s",
                 k, len(groups), sorted((len(v) for v in groups.values()), reverse=True))
        for idxs in groups.values():
            members = [asked[i] for i in idxs]
            all_members = list(members)
            mcfg = model_cfg_from_params(members[0].params, cfg.model)
            tcfg = train_cfg_from_params(members[0].params, cfg.train)
            if tcfg.batch_size > splits.n_train:
                tcfg = dataclasses.replace(tcfg, drop_remainder=False)
            shard = False
            if args.vectorize_shard:
                ranks = lane_world()[0]
                shard = len(members) % ranks == 0
                if not shard:
                    log.info("group of %d not a multiple of %d devices — unsharded", len(members), ranks)

            refill_fn = None
            if args.reclaim_lanes:
                group_arch = {key: members[0].params[key] for key in ARCH_KEYS}
                # Refills share the round's architecture, so an unbounded
                # round would drain the whole trial budget into one arch;
                # the cap ends the round so the next one samples a fresh arch.
                cap = args.reclaim_round_cap or 3 * len(members)

                def refill_fn(group_arch=group_arch, all_members=all_members, cap=cap):
                    # dead lane + budget left → ask ONE more trial with the
                    # group's architecture pinned (conditional proposal)
                    nonlocal asked_total
                    if asked_total >= args.trials or len(all_members) >= cap:
                        return None
                    t = study.ask(space, 1, fixed=group_arch)[0]
                    asked_total += 1
                    all_members.append(t)
                    return t.params, make_report(t)

            try:
                results = run_group(
                    splits, dims, mcfg, tcfg, [t.params for t in members],
                    report_fns=[make_report(t) for t in members],
                    shard_lanes=shard, refill_fn=refill_fn, device=args.device,
                )
            except Exception as e:  # noqa: BLE001 — a failed group must not kill the sweep
                log.exception("vectorized group of %d failed", len(all_members))
                for t in all_members:
                    # a trial that already reported epochs keeps its curve as
                    # TPE evidence ('pruned'); the others are 'failed'
                    study.tell(t, "pruned" if t.intermediates else "failed", error=repr(e))
                continue
            for t, r in zip(all_members, results):
                if r.pruned:
                    study.tell(t, "pruned")
                    continue
                t.set_user_attr("val_auc", r.final_metrics["val_auc"])
                t.set_user_attr("examples_per_s", r.examples_per_s)
                t.set_user_attr("group_examples_per_s", r.group_examples_per_s)
                if r.best_val_loss < best_box["value"]:
                    best_box["value"] = r.best_val_loss
                    log.info("new best (%.5f) — exporting artifacts to %s", r.best_val_loss, args.out)
                    # the manifest carries the WINNING trial's config: the
                    # group shares the arch dims, dropout is per lane
                    _export_best(args, r.params, r.bn_state,
                                 dataclasses.replace(mcfg, dropout=float(t.params["dropout"])),
                                 dims, preproc, r.final_metrics, t.number)
                rec = study.tell(t, "complete", r.best_val_loss)
                if rec["state"] == "complete":
                    log.info("trial %d complete: value %.5f", t.number, rec["value"])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="HPO sweep for DCN-R with the PyTorch port")
    p.add_argument("--trials", type=int, default=300)
    p.add_argument("--journal", default="artifacts/hpo_journal.jsonl")
    p.add_argument("--data", default="data")
    p.add_argument("--out", default="artifacts")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--regen", action="store_true", help="force-regenerate synthetic data")
    p.add_argument("--synth-users", type=int, default=2000)
    p.add_argument("--synth-items", type=int, default=600)
    p.add_argument("--synth-reviews", type=int, default=40000)
    p.add_argument("--epochs", type=int, default=None, help="cap epochs per trial")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pruner", choices=("median", "asha", "none"), default="median",
                   help="median = the reference study's MedianPruner; asha = successive halving "
                        "(rungs at min-resource·η^k epochs, top-1/η survive); none = no pruning. "
                        "Built-in backend only")
    p.add_argument("--asha-min-resource", type=int, default=1)
    p.add_argument("--asha-reduction-factor", type=int, default=3)
    p.add_argument("--cache-dir", default=None,
                   help="preprocessed-dataset cache (skips ingest on repeat runs)")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="run each trial over a device mesh (same layout as the train CLI: data-parallel "
                        "batch, row-sharded tables)")
    p.add_argument("--vectorize", type=int, default=1, metavar="K",
                   help="propose K trials per round and train each same-architecture group as ONE "
                        "K-lane program (hpo/vectorized.py); by default the K trials share one "
                        "sampled architecture per round (arch-major ask) so they form ONE group")
    p.add_argument("--reclaim-round-cap", type=int, default=0,
                   help="with --reclaim-lanes: max trials one vectorized round may consume before a "
                        "fresh architecture is sampled (0 = 3x the round's K)")
    p.add_argument("--reclaim-lanes", action="store_true",
                   help="with --vectorize: when a lane's trial prunes / early-stops / completes "
                        "mid-round, refill the lane with a freshly asked trial sharing the group's "
                        "architecture instead of letting it ride as dead weight")
    p.add_argument("--vectorize-independent", action="store_true",
                   help="with --vectorize: sample all K trials' params independently instead of "
                        "sharing the architecture dims (groups then degenerate to singletons)")
    p.add_argument("--vectorize-shard", action="store_true",
                   help="with --vectorize: shard the trial axis of each group over the world's ranks (one "
                        "a card; groups whose size is not a multiple of the ranks run unsharded)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*")
    return p


def main(argv=None) -> int:
    setup_logging()
    p = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    if args.vectorize > 1 and args.mesh:
        p.error("--vectorize and --mesh are mutually exclusive")
    if args.vectorize_shard and args.vectorize <= 1:
        p.error("--vectorize-shard requires --vectorize K (K > 1)")
    shape = None
    if args.mesh:
        from hhrs_tpu_torch.parallel.mesh import parse_mesh_spec

        try:
            shape = parse_mesh_spec(args.mesh)
        except ValueError as e:
            p.error(str(e))
    if args.reclaim_lanes and args.vectorize <= 1:
        p.error("--reclaim-lanes requires --vectorize K>1 (lanes to reclaim)")
    try:
        cfg = build_config(args.overrides, log=log)
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))
    if args.epochs is not None:
        cfg.train.n_epochs = args.epochs
    args.device = resolve_device(args.device)  # cuda unless asked: without a card, fail before any trial
    joined = False
    if (args.mesh or args.vectorize_shard) and not dist.is_initialized():
        rc = _world(args, argv, shape)
        if rc is not None:
            return rc
        joined = dist.is_initialized()
    try:
        return _run(args, cfg, shape)
    finally:
        if joined:
            dist.destroy_process_group()


def _world(args: argparse.Namespace, argv: list, shape: tuple | None):
    """Outside a world: join the one the environment configures (→ None, go
    on as a rank), or launch one on this node (→ rank 0's exit code): the
    mesh's ranks, or one rank a card for ``--vectorize-shard`` (None, and
    no world, where that is one rank or the device is the CPU)."""
    import torch

    from hhrs_tpu_torch.parallel.distributed import initialize_distributed, launch

    if initialize_distributed(device=args.device):
        return None
    ranks = shape[0] * shape[1] if shape else torch.cuda.device_count() if args.device.type == "cuda" else 1
    if ranks == 1 and not shape:
        return None
    if args.device.type == "cuda":
        from hhrs_tpu_torch.ops import cross, cuda_build

        cuda_build.build(cross._LIB_NAME, cross._LIB_SOURCES)  # once, before the ranks start
    log.info("launching %d ranks on %s for the study", ranks, args.device)
    # each rank runs this whole command, inside the world
    return launch(main, ranks, (list(argv),), device=args.device, timeout_s=float("inf"))


def _run(args: argparse.Namespace, cfg, shape: tuple | None) -> int:
    from hhrs_tpu_torch.models.dcn import ModelDims
    from hhrs_tpu_torch.train.cli import build_dataset, ensure_synthetic
    from hhrs_tpu_torch.train.trainer import train_dcn

    mesh = None
    if shape:
        from hhrs_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(*shape, args.device)
    leader = not dist.is_initialized() or dist.get_rank() == 0
    ensure_synthetic(args, cfg)
    splits, preproc = build_dataset(args.data, cfg, cache_dir=args.cache_dir)
    dims = ModelDims.from_artifacts(preproc)
    log.info("HPO over %d train rows, %d trials", splits.n_train, args.trials)

    space = reference_search_space()
    pruner = None  # Study's default: MedianPruner()
    if args.pruner == "asha":
        from hhrs_tpu_torch.hpo.pruner import SuccessiveHalvingPruner

        pruner = SuccessiveHalvingPruner(min_resource=args.asha_min_resource,
                                         reduction_factor=args.asha_reduction_factor)
    elif args.pruner == "none":
        from hhrs_tpu_torch.hpo.pruner import NopPruner

        pruner = NopPruner()
    kw = {} if pruner is None else {"pruner": pruner}
    study = create_study(args.journal, seed=args.seed, **kw)
    if dist.is_initialized():
        if not leader:
            study.journal_path = None  # the journal is read; from here on rank 0 alone appends
        dist.barrier()  # every rank has read the journal before rank 0 appends to it
    best_box = {"value": float("inf")}
    for t in study.trials:
        if t["state"] == "complete" and t["value"] is not None:
            best_box["value"] = min(best_box["value"], t["value"])

    def objective(trial):
        mcfg = model_cfg_from_params(trial.params, cfg.model)
        tcfg = train_cfg_from_params(trial.params, cfg.train)
        if tcfg.batch_size > splits.n_train:
            # small dataset + large sampled batch: wrap-pad instead of failing
            tcfg = dataclasses.replace(tcfg, drop_remainder=False)

        def report_fn(epoch: int, val_loss: float) -> bool:
            trial.report(val_loss, epoch)
            return trial.should_prune()

        result = train_dcn(splits, dims, mcfg, tcfg, mesh=mesh,
                           explicit_exchange=(cfg.mesh.explicit_exchange or None) if mesh else None,
                           exchange_capacity_factor=cfg.mesh.exchange_capacity_factor, report_fn=report_fn,
                           device=args.device)
        if result.pruned:
            raise TrialPruned()
        trial.set_user_attr("val_auc", result.final_metrics["val_auc"])
        trial.set_user_attr("examples_per_s", result.examples_per_s)
        if result.best_val_loss < best_box["value"]:
            best_box["value"] = result.best_val_loss
            log.info("new best (%.5f) — exporting artifacts to %s", result.best_val_loss, args.out)
            _export_best(args, result.params, result.bn_state, mcfg, dims, preproc, result.final_metrics,
                         trial.number)
        return result.best_val_loss

    if args.vectorize > 1:
        _optimize_vectorized(args, cfg, splits, dims, preproc, space, study, best_box)
    else:
        study.optimize(objective, space, n_trials=args.trials)

    try:
        log.info("best value: %.5f", study.best_value)
        log.info("best params: %s", study.best_params)
    except ValueError:
        log.warning("no completed trials (all pruned/failed)")

    if leader:
        try:  # the study's plots; matplotlib is optional
            from hhrs_tpu_torch.hpo.plots import save_study_plots

            save_study_plots(study.trials, args.out)
        except Exception as e:  # noqa: BLE001 — plotting must never fail the sweep
            log.warning("study plots skipped: %s", e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
