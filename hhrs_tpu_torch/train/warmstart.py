"""Warm-start fine-tuning: continue a shipped model on fresher data
(counterpart of ``hhrs_tpu/train/warmstart.py``, on the port's column
tables).

* Preprocessing is anchored to the artifact: the categorical encoders, the
  numerical medians and the min-max scaler are frozen (unknown category →
  0, as at serving time); refitting them would shift every feature the
  copied weights were trained against.
* The user and item vocabularies grow: ids the artifact knows keep their
  rows, unseen ids append in order of first appearance, so the fine-tuned
  artifact stays id-compatible with the old one.
* The parameters copy row-aligned: a fresh model at the grown sizes (the
  initialization of a cold run with the same seed), the artifact's table
  rows copied over its first rows, every other leaf and the BatchNorm
  state copied as they are (the architecture comes from the artifact's
  manifest). A changed feature layout is refused.
* The optimizer's moments start at zero, and the shuffle and dropout
  streams are a cold run's (``train_dcn``'s ``init_state``).

CLI: ``python -m hhrs_tpu_torch.train.cli --init-from <artifact_dir>``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.preprocess import (DatasetSplits, PreprocessArtifacts, Preprocessor, drop_missing_categories,
                                            scaled_numericals)
from hhrs_tpu_torch.data.table import map_fill, n_rows, unique_first
from hhrs_tpu_torch.models.convert import jax_from_dcnr
from hhrs_tpu_torch.models.dcn import DCNR, ModelDims
from hhrs_tpu_torch.train.artifacts import ArtifactBundle

log = logging.getLogger(__name__)


@dataclass
class WarmStart:
    """Everything ``train_dcn`` needs for a fine-tuning run."""

    splits: DatasetSplits
    preproc: PreprocessArtifacts  # grown vocabularies, frozen encoders and statistics
    dims: ModelDims
    params: dict
    bn_state: dict
    n_new_users: int
    n_new_items: int


def extend_mapping(mapping: dict, ids) -> tuple[dict, int]:
    """Old ids keep their rows; unseen ids append in order of first
    appearance → (the grown mapping, the number of rows appended)."""
    out = dict(mapping)
    n = len(out)
    for key in unique_first(np.asarray(ids)).tolist():
        if key not in out:
            out[key] = n
            n += 1
    return out, n - len(mapping)


def _encode(preproc: PreprocessArtifacts, table: dict):
    """Encode with the grown user and item vocabularies (which cover every
    row) and the frozen encoders and statistics."""
    n = n_rows(table)
    users = np.array([preproc.user_id_mapping[u] for u in table[schema.USER_COL].tolist()], np.int32)
    items = np.array([preproc.item_id_mapping[t] for t in table[schema.ITEM_COL].tolist()], np.int32)
    cats = [map_fill(table[col], preproc.cat_encoders[col], 0).astype(np.int32)
            for col in preproc.categorical_cols]
    x_cat = np.stack(cats, axis=1) if cats else np.zeros((n, 0), np.int32)
    y = table[schema.TARGET_COL].astype(np.float32)
    return users.reshape(n), items.reshape(n), x_cat, scaled_numericals(preproc, table, n), y


def prepare_warm_start(
    bundle: ArtifactBundle,
    table: dict,
    test_size: float = 0.2,
    split_seed: int = 42,
    init_seed: int = 42,
) -> WarmStart:
    """The fine-tuning dataset and starting weights from a shipped artifact
    bundle and a noise-filtered, feature-engineered review table."""
    table = drop_missing_categories(table, bundle.preproc.categorical_cols)
    user_map, n_new_users = extend_mapping(bundle.preproc.user_id_mapping, table[schema.USER_COL])
    item_map, n_new_items = extend_mapping(bundle.preproc.item_id_mapping, table[schema.ITEM_COL])
    preproc = PreprocessArtifacts(
        user_id_mapping=user_map,
        item_id_mapping=item_map,
        cat_encoders=bundle.preproc.cat_encoders,
        scaler=bundle.preproc.scaler,
        numerical_cols=bundle.preproc.numerical_cols,
        categorical_cols=bundle.preproc.categorical_cols,
        medians=bundle.preproc.medians,
    )
    dims = ModelDims.from_artifacts(preproc)
    if dict(dims.cat_dims) != dict(bundle.dims.cat_dims) or dims.n_num_features != bundle.dims.n_num_features:
        raise ValueError(
            "warm start: categorical/numerical feature layout differs from "
            f"the artifact ({dict(dims.cat_dims)}/{dims.n_num_features} vs "
            f"{dict(bundle.dims.cat_dims)}/{bundle.dims.n_num_features})"
        )

    # A fresh model at the grown sizes (new rows keep its values), then the
    # artifact's weights row-aligned over it.
    fresh = DCNR(dims, bundle.model_cfg, generator=torch.Generator().manual_seed(init_seed))
    params, _ = jax_from_dcnr(fresh)

    def copy_rows(fresh_rows: np.ndarray, trained) -> np.ndarray:
        trained = np.asarray(trained)
        if fresh_rows.shape[1:] != trained.shape[1:] or fresh_rows.shape[0] < trained.shape[0]:
            raise ValueError(f"warm start: table shape {trained.shape} does not embed in {fresh_rows.shape}")
        out = fresh_rows.copy()
        out[: trained.shape[0]] = trained
        return out

    for k in ("user_embedding", "item_embedding"):
        params[k] = copy_rows(params[k], bundle.params[k])
    for k, v in bundle.params.items():
        if k not in ("user_embedding", "item_embedding"):
            params[k] = v  # the tower and the categorical tables: shapes equal by construction

    users, items, x_cat, x_num, y = _encode(preproc, table)
    tr_idx, va_idx = Preprocessor(test_size=test_size, split_seed=split_seed)._split(len(y))
    splits = DatasetSplits(
        train_user=users[tr_idx], train_item=items[tr_idx], train_cat=x_cat[tr_idx],
        train_num=x_num[tr_idx], train_y=y[tr_idx],
        val_user=users[va_idx], val_item=items[va_idx], val_cat=x_cat[va_idx],
        val_num=x_num[va_idx], val_y=y[va_idx],
    )
    log.info("warm start: %d users (+%d new), %d items (+%d new), %d train / %d val",
             dims.n_users, n_new_users, dims.n_items, n_new_items, splits.n_train, splits.n_val)
    return WarmStart(splits=splits, preproc=preproc, dims=dims, params=params, bn_state=bundle.bn_state,
                     n_new_users=n_new_users, n_new_items=n_new_items)
