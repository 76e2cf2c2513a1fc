"""Training entry point: ``python -m hhrs_tpu_torch.train.cli``.

Counterpart of ``hhrs_tpu/train/cli.py``, with its flags plus ``--device``:
ingest the reviews CSV (or generate synthetic data), noise-filter, add the
engineered features, fit the ``Preprocessor`` (or warm-start from a shipped
artifact's frozen preprocessing with ``--init-from``), train DCN-R with
``train_dcn``, export an artifact directory that both packages load, and
register it in a model registry when asked::

    python -m hhrs_tpu_torch.train.cli --data data --out artifacts \\
        [--epochs N] [--preset tuned|reference] [--device cuda|cpu] \\
        [--synthetic [--regen] [--synth-users N] [--synth-items N] [--synth-reviews N]] \\
        [--cache-dir DIR] [--checkpoint-dir DIR] [--init-from ARTIFACT_DIR] \\
        [--metrics-log FILE] [--profile-dir DIR] \\
        [--register-db DB [--promote [--promote-metric M]]] [section.field=value ...]

The config is layered as in the JAX CLI: defaults, then ``--preset`` (or
``HHRS_PRESET``), then ``HHRS_<SECTION>_<FIELD>`` environment variables,
then the positional overrides. The device defaults to ``cuda`` and the run
fails without a card.

``--mesh DATAxMODEL`` trains over a mesh of ``DATA·MODEL`` ranks
(``train_dcn``'s mesh mode, with ``mesh.explicit_exchange`` and
``mesh.exchange_capacity_factor``): when the environment configures a
world (``parallel/distributed.py::initialize_distributed``: the JAX
wrapper's variables or torchrun's) this process joins it as one rank;
otherwise it launches a world of that many ranks on this node (NCCL with a
card each, gloo where ranks share a card or on the CPU) and waits for it.
``--distributed`` joins the world the environment configures (and fails
without one); without ``--mesh`` its mesh is every rank on ``data``.
Every rank runs the whole command; rank 0 alone writes the artifact, the
metrics log and the registry entry.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import logging
import os
import sys

from hhrs_tpu_torch.config import Config, build_config
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu_torch.data.preprocess import Preprocessor
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train.artifacts import export_artifacts
from hhrs_tpu_torch.train.trainer import train_dcn
from hhrs_tpu_torch.utils.logging import MetricsLogger, setup_logging

log = logging.getLogger("hhrs_tpu_torch.train")
REVIEWS_CSV = "hackathon_augmented_data.csv"


def ensure_synthetic(args, cfg: Config) -> str:
    """Generate the synthetic CSVs into ``args.data`` where asked and
    missing (or with ``--regen``) → the reviews CSV's path."""
    csv_path = os.path.join(args.data, REVIEWS_CSV)
    if args.synthetic and (not os.path.exists(csv_path) or getattr(args, "regen", False)):
        from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset

        log.info("generating synthetic dataset in %s", args.data)
        write_synthetic_dataset(args.data, n_users=args.synth_users, n_items=args.synth_items,
                                n_reviews=args.synth_reviews, seed=cfg.train.seed)
    return csv_path


def load_frame(csv_path: str, cfg: Config) -> dict:
    """Ingest → noise filter → engineered features (the table before
    encoding, shared by a fit and a warm start)."""
    table = noise_filter(load_reviews_csv(csv_path), cfg.data.positive_rating, cfg.data.negative_rating)
    return add_engineered_features(table)


def cache_knobs(cfg: Config) -> dict:
    """The preprocessing settings a cached dataset depends on."""
    return {"pos": cfg.data.positive_rating, "neg": cfg.data.negative_rating,
            "cat": list(cfg.data.categorical_cols), "num": list(cfg.data.numerical_cols),
            "test_size": cfg.data.test_size, "seed": cfg.data.split_seed, "leakage": cfg.data.leakage_compat}


def build_dataset(data_dir: str, cfg: Config, cache_dir: str | None = None):
    """Reviews CSV → (DatasetSplits, PreprocessArtifacts); with ``cache_dir``
    a run with the same CSV and settings loads them from there."""
    csv_path = os.path.join(data_dir, REVIEWS_CSV)
    key = None
    if cache_dir:
        from hhrs_tpu_torch.data import cache

        key = cache.cache_key(csv_path, cache_knobs(cfg))
        hit = cache.load(cache_dir, key)
        if hit is not None:
            return hit
    pre = Preprocessor(
        categorical_cols=cfg.data.categorical_cols,
        numerical_cols=cfg.data.numerical_cols,
        test_size=cfg.data.test_size,
        split_seed=cfg.data.split_seed,
        leakage_compat=cfg.data.leakage_compat,
    )
    splits, artifacts = pre.fit_transform(load_frame(csv_path, cfg))
    if cache_dir:
        cache.save(cache_dir, key, splits, artifacts)
    return splits, artifacts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the DCN-R ranker with the PyTorch port")
    p.add_argument("--data", default="data", help="data dir with the two CSVs")
    p.add_argument("--out", default="artifacts", help="artifact output dir")
    p.add_argument("--synthetic", action="store_true", help="generate synthetic data if missing")
    p.add_argument("--regen", action="store_true", help="force-regenerate synthetic data")
    p.add_argument("--synth-users", type=int, default=2000)
    p.add_argument("--synth-items", type=int, default=600)
    p.add_argument("--synth-reviews", type=int, default=40000)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--metrics-log", default=None, help="JSONL per-epoch metrics sink")
    p.add_argument("--cache-dir", default=None,
                   help="preprocessed-dataset cache (skips ingest on repeat runs)")
    p.add_argument("--checkpoint-dir", default=None, help="checkpoint dir (resume-from-latest)")
    p.add_argument("--init-from", default=None, metavar="ARTIFACT_DIR",
                   help="warm-start fine-tuning from a shipped artifact dir: encoders and scaler "
                        "frozen to the artifact, user/item vocabs grow (old ids keep their rows), "
                        "tower weights copied; the architecture comes from the artifact's manifest")
    p.add_argument("--register-db", default=None,
                   help="register exported artifacts as the active model in this sqlite registry")
    p.add_argument("--promote", action="store_true",
                   help="with --register-db: activate only if the run beats the active model on "
                        "--promote-metric (losers are registered inactive)")
    p.add_argument("--promote-metric", default="val_logloss",
                   help="metric for --promote (direction inferred from its name)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace of the run (trace.json) and the program's "
                        "counters (counters.json) into this dir")
    p.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                   help="train over a device mesh, e.g. 2 or 2x2 (data-parallel batch, row-sharded tables): "
                        "joins the world the environment configures, else launches that many ranks here")
    p.add_argument("--distributed", action="store_true",
                   help="join the multi-process world the environment configures (COORDINATOR_ADDRESS/"
                        "NUM_PROCESSES/PROCESS_ID or torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)")
    p.add_argument("--preset", default=None,
                   help="named config preset applied before the environment and the overrides "
                        "(e.g. 'tuned' = B=32768 + rng_impl=rbg + bf16 compute and storage; "
                        "env: HHRS_PRESET)")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("overrides", nargs="*", help="section.field=value config overrides")
    return p


def main(argv=None) -> int:
    return run(argv)[0]


def _world(p: argparse.ArgumentParser, args: argparse.Namespace, argv: list):
    """``--mesh`` / ``--distributed`` outside a world: join the one the
    environment configures (→ None, go on as a rank), or launch a world of
    ``DATA·MODEL`` ranks on this node (→ rank 0's exit code)."""
    from hhrs_tpu_torch.device import resolve_device
    from hhrs_tpu_torch.parallel.distributed import initialize_distributed, launch
    from hhrs_tpu_torch.parallel.mesh import parse_mesh_spec

    try:
        shape = parse_mesh_spec(args.mesh) if args.mesh else None
    except ValueError as e:
        p.error(str(e))
    device = resolve_device(args.device)  # no card and no --device: raises, never falls back to the CPU
    if initialize_distributed(device=device):
        return None
    if args.distributed:
        p.error("--distributed needs a world configured by the environment (COORDINATOR_ADDRESS, NUM_PROCESSES "
                "and PROCESS_ID, or MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK)")
    if device.type == "cuda":
        from hhrs_tpu_torch.ops import cross, cuda_build

        cuda_build.build(cross._LIB_NAME, cross._LIB_SOURCES)  # once, before the ranks start
    log.info("launching a mesh of %dx%d ranks on %s", *shape, device)
    # each rank runs this whole command, inside the world
    return launch(main, shape[0] * shape[1], (list(argv),), device=device, timeout_s=float("inf"))


def run(argv=None) -> tuple:
    """:func:`main`'s work → (exit code, the run's ``TrainResult``, or None
    when no run took place or this process launched a world)."""
    import torch.distributed as dist

    setup_logging()
    p = build_parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = p.parse_args(argv)
    try:
        cfg = build_config(args.overrides, preset=args.preset, log=log)
    except (ValueError, NotImplementedError) as e:
        p.error(str(e))
    if args.epochs is not None:
        cfg.train.n_epochs = args.epochs
    if args.promote and not args.register_db:
        p.error("--promote requires --register-db (nothing to gate into)")
    joined = False
    if (args.mesh or args.distributed) and not dist.is_initialized():
        rc = _world(p, args, argv)
        if rc is not None:
            return rc, None
        joined = True
    try:
        return _run(args, cfg)
    finally:
        if joined:
            dist.destroy_process_group()


def _run(args: argparse.Namespace, cfg: Config) -> tuple:
    mesh = None
    if args.mesh or args.distributed:
        import torch.distributed as dist

        from hhrs_tpu_torch.device import resolve_device
        from hhrs_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec

        data, model = parse_mesh_spec(args.mesh) if args.mesh else (-1, 1)
        mesh = make_mesh(data, model, resolve_device(args.device))
        leader = dist.get_rank() == 0
    else:
        leader = True

    init_state = None
    try:
        csv_path = ensure_synthetic(args, cfg)
        if args.init_from:
            from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
            from hhrs_tpu_torch.train.warmstart import prepare_warm_start

            bundle = load_artifact_bundle(args.init_from)
            if cfg.model != bundle.model_cfg:
                log.info("warm start: model config comes from %s's manifest (CLI model.* overrides ignored)",
                         args.init_from)
            cfg.model = bundle.model_cfg
            ws = prepare_warm_start(bundle, load_frame(csv_path, cfg), test_size=cfg.data.test_size,
                                    split_seed=cfg.data.split_seed, init_seed=cfg.train.seed)
            splits, preproc = ws.splits, ws.preproc
            init_state = (ws.params, ws.bn_state)
        else:
            splits, preproc = build_dataset(args.data, cfg, cache_dir=args.cache_dir)
    except FileNotFoundError as e:
        log.error("data file not found: %s (pass --synthetic to generate)", e)
        return 1, None
    dims = ModelDims.from_artifacts(preproc)
    log.info("training DCN-R: %d users, %d items, cat_dims=%s, %d train / %d val",
             dims.n_users, dims.n_items, dict(dims.cat_dims), splits.n_train, splits.n_val)

    metrics_logger = MetricsLogger(args.metrics_log) if args.metrics_log and leader else None
    if args.profile_dir:
        from hhrs_tpu_torch.utils.profiling import trace

        profile_cm = trace(args.profile_dir)
    else:
        profile_cm = contextlib.nullcontext()
    try:
        with profile_cm:
            result = train_dcn(splits, dims, cfg.model, cfg.train, mesh=mesh,
                               explicit_exchange=cfg.mesh.explicit_exchange or None,
                               exchange_capacity_factor=cfg.mesh.exchange_capacity_factor,
                               checkpoint_dir=args.checkpoint_dir, init_state=init_state, device=args.device,
                               metrics_logger=metrics_logger)
    finally:
        if metrics_logger is not None:
            metrics_logger.close()
    m = result.final_metrics
    log.info("Final Validation LogLoss: %.4f", m["val_logloss"])
    log.info("Final Validation AUC:     %.4f", m["val_auc"])
    log.info("Final Validation RMSE:    %.4f", m["val_rmse"])
    log.info("Throughput: %.0f examples/s", result.examples_per_s)

    export_artifacts(args.out, result.params, result.bn_state, cfg.model, dims, preproc, m,
                     train_cfg=cfg.train)
    if not leader:  # a mesh: rank 0 wrote the artifact; the registry is its job too
        return 0, result
    log.info("artifacts exported to %s", args.out)

    if args.register_db:
        from hhrs_tpu_torch.db.registry import ModelRegistry

        reg = ModelRegistry(args.register_db, create=True)
        hyperparams = dataclasses.asdict(cfg.model)
        if args.promote:
            mid, promoted, reason = reg.promote_if_better(None, args.out, metrics=m, hyperparams=hyperparams,
                                                          metric=args.promote_metric)
            log.info("model_id=%d %s in %s — %s", mid, "PROMOTED" if promoted else "registered inactive",
                     args.register_db, reason)
        else:
            mid = reg.register(None, args.out, metrics=m, hyperparams=hyperparams)
            log.info("registered model_id=%d in %s", mid, args.register_db)
    return 0, result


if __name__ == "__main__":
    sys.exit(main())
