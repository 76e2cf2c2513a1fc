"""Saved preprocessing artifacts and per-item featurization.

Counterpart of ``MinMaxStats``, ``PreprocessArtifacts`` (load side only) and
``encode_item_features`` in ``hhrs_tpu/data/preprocess.py``. Serve-time
fallbacks are kept: unknown user → ``n_users // 2``, unknown item → 0,
unknown or missing category → 0; numericals are filled with the train
medians, then min-max scaled with the train scaler.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import map_fill


@dataclass
class MinMaxStats:
    """MinMax scaling with sklearn's zero-range convention (scale=1)."""

    data_min: np.ndarray
    data_max: np.ndarray

    @property
    def scale(self) -> np.ndarray:
        rng = self.data_max - self.data_min
        return np.where(rng == 0.0, 1.0, rng)

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (np.asarray(x, dtype=np.float64) - self.data_min) / self.scale


def _json_map(m) -> dict:
    """A vocabulary as stored in preproc.json: ``[key, code]`` pairs with
    native JSON keys, or (older artifacts) a string-keyed object."""
    if isinstance(m, dict):
        out = {}
        for k, v in m.items():
            for cast in (int, float, str):
                try:
                    out[cast(k)] = int(v)
                    break
                except ValueError:
                    continue
        return out
    return {k: int(v) for k, v in m}


@dataclass
class PreprocessArtifacts:
    """Everything the serve path needs to featurize a request."""

    user_id_mapping: dict
    item_id_mapping: dict
    cat_encoders: dict  # col -> {category: code}
    scaler: MinMaxStats
    numerical_cols: list
    categorical_cols: list
    medians: dict  # col -> median used for NaN fill

    @property
    def n_users(self) -> int:
        return len(self.user_id_mapping)

    @property
    def n_items(self) -> int:
        return len(self.item_id_mapping)

    @property
    def cat_dims(self) -> dict:
        return {col: len(enc) for col, enc in self.cat_encoders.items()}

    @property
    def unknown_user_id(self) -> int:
        return len(self.user_id_mapping) // 2

    @classmethod
    def from_json_dict(cls, d: dict) -> "PreprocessArtifacts":
        return cls(
            user_id_mapping=_json_map(d["user_id_mapping"]),
            item_id_mapping=_json_map(d["item_id_mapping"]),
            cat_encoders={col: _json_map(enc) for col, enc in d["cat_encoders"].items()},
            scaler=MinMaxStats(
                data_min=np.asarray(d["scaler_min"], dtype=np.float64),
                data_max=np.asarray(d["scaler_max"], dtype=np.float64),
            ),
            numerical_cols=list(d["numerical_cols"]),
            categorical_cols=list(d["categorical_cols"]),
            medians=dict(d["medians"]),
        )

    @classmethod
    def load(cls, path: str) -> "PreprocessArtifacts":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


def encode_item_features(
    artifacts: PreprocessArtifacts, items: dict
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-item featurization of a table of item rows → (item codes [n]
    int32, categorical codes [n, C] int32, scaled numericals [n, F] f32)."""
    n = len(items[schema.ITEM_COL])
    item_codes = map_fill(items[schema.ITEM_COL], artifacts.item_id_mapping, 0).astype(np.int32)
    cats = [
        map_fill(items[col], artifacts.cat_encoders[col], 0).astype(np.int32)
        for col in artifacts.categorical_cols
    ]
    x_cat = np.stack(cats, axis=1) if cats else np.zeros((n, 0), np.int32)
    raw = np.stack(
        [items[c].astype(np.float64) for c in artifacts.numerical_cols], axis=1
    ).reshape(n, len(artifacts.numerical_cols))
    med = np.asarray([artifacts.medians[c] for c in artifacts.numerical_cols])
    raw = np.where(np.isnan(raw), med, raw)
    x_num = artifacts.scaler.transform(raw).astype(np.float32)
    return item_codes, x_cat, x_num
