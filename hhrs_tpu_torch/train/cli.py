"""Training entry point: ``python -m hhrs_tpu_torch.train.cli``.

Counterpart of ``hhrs_tpu/train/cli.py`` (``build_dataset``, ``main``):
ingest the reviews CSV, noise-filter, add the engineered features, fit the
``Preprocessor``, train DCN-R with ``train_dcn`` and export an artifact
directory that both packages load::

    python -m hhrs_tpu_torch.train.cli --data data --out artifacts \\
        [--epochs N] [--device cuda|cpu] [--checkpoint-dir DIR] \\
        [section.field=value ...]

The device defaults to ``cuda`` and the run fails without a card. With
``--checkpoint-dir`` the loop state is saved after every epoch and a rerun
of the same command resumes from the last saved epoch.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from hhrs_tpu_torch.config import Config
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu_torch.data.preprocess import Preprocessor
from hhrs_tpu_torch.models.dcn import ModelDims
from hhrs_tpu_torch.train.artifacts import export_artifacts
from hhrs_tpu_torch.train.trainer import train_dcn

log = logging.getLogger("hhrs_tpu_torch.train")
REVIEWS_CSV = "hackathon_augmented_data.csv"


def build_dataset(data_dir: str, cfg: Config):
    """Reviews CSV → (DatasetSplits, PreprocessArtifacts)."""
    table = load_reviews_csv(os.path.join(data_dir, REVIEWS_CSV))
    table = add_engineered_features(
        noise_filter(table, cfg.data.positive_rating, cfg.data.negative_rating))
    pre = Preprocessor(
        categorical_cols=cfg.data.categorical_cols,
        numerical_cols=cfg.data.numerical_cols,
        test_size=cfg.data.test_size,
        split_seed=cfg.data.split_seed,
        leakage_compat=cfg.data.leakage_compat,
    )
    return pre.fit_transform(table)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s")
    p = argparse.ArgumentParser(description="Train the DCN-R ranker with the PyTorch port")
    p.add_argument("--data", default="data", help=f"data dir holding {REVIEWS_CSV}")
    p.add_argument("--out", default="artifacts", help="artifact output dir")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--checkpoint-dir", default=None, help="checkpoint dir (resume-from-latest)")
    p.add_argument("overrides", nargs="*", help="section.field=value config overrides")
    args = p.parse_args(argv)

    cfg = Config()
    try:
        cfg.apply_overrides(args.overrides)
    except ValueError as e:
        p.error(str(e))
    if args.epochs is not None:
        cfg.train.n_epochs = args.epochs

    try:
        splits, preproc = build_dataset(args.data, cfg)
    except FileNotFoundError as e:
        log.error("data file not found: %s", e)
        return 1
    dims = ModelDims.from_artifacts(preproc)
    log.info("training DCN-R: %d users, %d items, cat_dims=%s, %d train / %d val",
             dims.n_users, dims.n_items, dict(dims.cat_dims), splits.n_train, splits.n_val)

    result = train_dcn(splits, dims, cfg.model, cfg.train, checkpoint_dir=args.checkpoint_dir,
                       device=args.device)
    m = result.final_metrics
    log.info("Final Validation LogLoss: %.4f", m["val_logloss"])
    log.info("Final Validation AUC:     %.4f", m["val_auc"])
    log.info("Final Validation RMSE:    %.4f", m["val_rmse"])
    log.info("Throughput: %.0f examples/s", result.examples_per_s)

    export_artifacts(args.out, result.params, result.bn_state, cfg.model, dims, preproc, m,
                     train_cfg=cfg.train)
    log.info("artifacts exported to %s", args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
