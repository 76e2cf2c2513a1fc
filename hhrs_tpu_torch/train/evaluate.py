"""Artifact evaluation without a refit (counterpart of
``hhrs_tpu/train/evaluate.py``): the core of ``train/eval_cli.py`` and of
the promote gate's ``--eval-data`` mode (``db/cli.py``), which scores the
candidate and the incumbent on the same rows.

The dataset is encoded with the artifact's saved preprocessing
(``transform_with_artifacts``: unseen ids take the serving fallbacks) and
scored by the model in eval mode, in ``eval_batch`` chunks, as the
trainer's ``eval_logits`` scores (on a card through the cross forward
kernel).
"""

from __future__ import annotations

import os

import torch

from hhrs_tpu_torch.config import Config
from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.features import add_engineered_features
from hhrs_tpu_torch.data.ingest import load_reviews_csv, noise_filter
from hhrs_tpu_torch.data.preprocess import Preprocessor, transform_with_artifacts
from hhrs_tpu_torch.device import resolve_device
from hhrs_tpu_torch.models.convert import dcnr_from_jax
from hhrs_tpu_torch.retrieval.similarity import require_full_f32_matmul
from hhrs_tpu_torch.train.artifacts import load_artifact_bundle
from hhrs_tpu_torch.train.metrics import auc_score, bce_with_logits, recall_at_k, rmse_of_probs
from hhrs_tpu_torch.train.trainer import SPLIT_DTYPES, eval_logits

SPLITS = ("all", "val", "train")


def evaluate_artifacts(
    artifacts_dir: str,
    data_dir: str,
    cfg: Config | None = None,
    split: str = "all",
    eval_batch: int = 8192,
    device: str | torch.device | None = None,
) -> dict:
    """Evaluate one artifact dir on ``data_dir``'s reviews CSV → ``{"rows",
    "logloss", "auc", "rmse", "recall_at_100"}``. ``split`` ∈ {all, val,
    train}: val and train reproduce the training run's split of this
    table (``cfg.data``'s noise filter, test size and seed). Raises
    ``ValueError`` when the data has no target column or no row is left.
    ``device`` defaults to ``cuda`` and raises without a card."""
    if split not in SPLITS:
        raise ValueError(f"unknown split {split!r}; expected one of {SPLITS}")
    cfg = cfg or Config()
    dev = resolve_device(device)
    require_full_f32_matmul(dev)
    bundle = load_artifact_bundle(artifacts_dir)
    table = add_engineered_features(load_reviews_csv(os.path.join(data_dir, "hackathon_augmented_data.csv")))
    # the training run's thresholds: the same rows, so that --split val is its split
    table = noise_filter(table, cfg.data.positive_rating, cfg.data.negative_rating)
    arrays = transform_with_artifacts(bundle.preproc, table)
    if "y" not in arrays:
        raise ValueError(f"dataset has no {schema.TARGET_COL!r} column — nothing to evaluate against")
    if split != "all":
        pre = Preprocessor(test_size=cfg.data.test_size, split_seed=cfg.data.split_seed)
        tr_idx, va_idx = pre._split(len(arrays["y"]))
        keep = va_idx if split == "val" else tr_idx
        arrays = {k: v[keep] for k, v in arrays.items()}

    n = len(arrays["y"])
    if n == 0:
        raise ValueError("no rows to evaluate after filtering")
    model = dcnr_from_jax(bundle.params, bundle.bn_state, bundle.dims, bundle.model_cfg, dev)
    data = {name: torch.as_tensor(arrays[name], dtype=dtype, device=dev) for name, dtype in SPLIT_DTYPES.items()}
    logits = eval_logits(model, data, eval_batch)
    logloss = float(bce_with_logits(logits, data["y"]))
    logits = logits.cpu().numpy()
    y = arrays["y"]
    return {
        "rows": int(n),
        "logloss": logloss,
        "auc": auc_score(y, logits),
        "rmse": rmse_of_probs(y, logits),
        "recall_at_100": recall_at_k(arrays["user"], y, logits, 100),
    }
