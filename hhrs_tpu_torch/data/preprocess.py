"""Preprocessing: vocab maps, categorical encoders, min-max scaling, split;
the saved artifacts and per-item featurization.

Counterpart of ``MinMaxStats``, ``PreprocessArtifacts``, ``DatasetSplits``,
``Preprocessor``, ``transform_with_artifacts`` and ``encode_item_features`` in
``hhrs_tpu/data/preprocess.py``, on the port's column tables
(:mod:`hhrs_tpu_torch.data.table`) in place of pandas frames. The fit keeps
the reference's semantics:

* numericals filled with their medians (NaN skipped, ``np.nanmedian``), rows
  with a missing categorical dropped;
* user and item vocabularies in order of first appearance;
* category codes in sorted category order (``pd.Categorical``);
* min-max scaling, by default fit on the full table before the split (the
  reference's leakage quirk); ``leakage_compat=False`` fits medians and
  scaler on the train rows only;
* the split of ``sklearn.model_selection.train_test_split(test_size,
  random_state)``: ``n_test = ceil(test_size · n)``, a
  ``np.random.RandomState(seed).permutation(n)``, test rows first.

Serve-time fallbacks are kept: unknown user → ``n_users // 2``, unknown
item → 0, unknown or missing category → 0; numericals are filled with the
train medians, then min-max scaled with the train scaler.
"""

from __future__ import annotations

import json
import math
import warnings
from dataclasses import dataclass

import numpy as np

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import isna, map_fill, n_rows, take, unique_first


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

    @classmethod
    def fit(cls, x: np.ndarray) -> "MinMaxStats":
        x = np.asarray(x, dtype=np.float64)
        return cls(data_min=np.nanmin(x, axis=0), data_max=np.nanmax(x, axis=0))


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

    def to_json_dict(self) -> dict:
        """Vocabularies as ``[key, code]`` pairs with native JSON keys (the
        JAX package's format, which round-trips int and float ids)."""

        def pairs(m):
            return [[k.item() if hasattr(k, "item") else k, int(v)] for k, v in m.items()]

        return {
            "user_id_mapping": pairs(self.user_id_mapping),
            "item_id_mapping": pairs(self.item_id_mapping),
            "cat_encoders": {col: pairs(enc) for col, enc in self.cat_encoders.items()},
            "scaler_min": self.scaler.data_min.tolist(),
            "scaler_max": self.scaler.data_max.tolist(),
            "numerical_cols": list(self.numerical_cols),
            "categorical_cols": list(self.categorical_cols),
            "medians": {k: float(v) for k, v in self.medians.items()},
        }

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json_dict(), f)

    @classmethod
    def load(cls, path: str) -> "PreprocessArtifacts":
        with open(path) as f:
            return cls.from_json_dict(json.load(f))


@dataclass
class DatasetSplits:
    """Encoded arrays, already split."""

    train_user: np.ndarray
    train_item: np.ndarray
    train_cat: np.ndarray
    train_num: np.ndarray
    train_y: np.ndarray
    val_user: np.ndarray
    val_item: np.ndarray
    val_cat: np.ndarray
    val_num: np.ndarray
    val_y: np.ndarray

    @property
    def n_train(self) -> int:
        return len(self.train_y)

    @property
    def n_val(self) -> int:
        return len(self.val_y)


def _nanmedian(x: np.ndarray) -> float:
    """``pd.Series.median``: NaN skipped; an all-NaN column gives NaN."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return float(np.nanmedian(x)) if len(x) else float("nan")


class Preprocessor:
    """Fit/transform with the reference's exact semantics (see the module
    docstring)."""

    def __init__(
        self,
        user_col: str = schema.USER_COL,
        item_col: str = schema.ITEM_COL,
        target_col: str = schema.TARGET_COL,
        categorical_cols=schema.CATEGORICAL_COLS,
        numerical_cols=schema.NUMERICAL_COLS,
        test_size: float = 0.2,
        split_seed: int = 42,
        leakage_compat: bool = True,
    ):
        self.user_col = user_col
        self.item_col = item_col
        self.target_col = target_col
        self.categorical_cols = list(categorical_cols)
        self.numerical_cols = list(numerical_cols)
        self.test_size = test_size
        self.split_seed = split_seed
        self.leakage_compat = leakage_compat

    def fit_transform(self, table: dict) -> tuple[DatasetSplits, PreprocessArtifacts]:
        num = {c: table[c].astype(np.float64) for c in self.numerical_cols}
        has_cats = np.ones(len(table[self.target_col]), dtype=bool)
        for col in self.categorical_cols:
            has_cats &= ~np.array([isna(v) for v in table[col].tolist()], dtype=bool)

        if self.leakage_compat:
            # full-table medians before the categorical drop (reference order)
            medians = {c: _nanmedian(num[c]) for c in self.numerical_cols}
            table = take(table, has_cats)
            num = {c: v[has_cats] for c, v in num.items()}
            pre_idx = None
        else:
            # no full-table statistics: medians and scaler from the train rows
            table = take(table, has_cats)
            num = {c: v[has_cats] for c, v in num.items()}
            pre_idx = self._split(len(table[self.target_col]))
            medians = {c: _nanmedian(num[c][pre_idx[0]]) for c in self.numerical_cols}
        num = {c: np.where(np.isnan(v), medians[c], v) for c, v in num.items()}

        user_map = {u: i for i, u in enumerate(unique_first(table[self.user_col]).tolist())}
        item_map = {t: i for i, t in enumerate(unique_first(table[self.item_col]).tolist())}
        user_enc = np.array([user_map[u] for u in table[self.user_col].tolist()], dtype=np.int32)
        item_enc = np.array([item_map[t] for t in table[self.item_col].tolist()], dtype=np.int32)

        n = len(user_enc)
        cat_encoders, cat_cols = {}, []
        for col in self.categorical_cols:
            values = table[col].tolist()
            cat_encoders[col] = {c: i for i, c in enumerate(sorted(set(values)))}
            cat_cols.append(np.array([cat_encoders[col][v] for v in values], dtype=np.int32))
        x_cat = np.stack(cat_cols, axis=1) if cat_cols else np.zeros((n, 0), np.int32)

        x_num_raw = np.stack([num[c] for c in self.numerical_cols], axis=1).reshape(
            n, len(self.numerical_cols))
        y = table[self.target_col].astype(np.float32)

        if self.leakage_compat:
            scaler = MinMaxStats.fit(x_num_raw)
            tr_idx, va_idx = self._split(n)
        else:
            tr_idx, va_idx = pre_idx
            scaler = MinMaxStats.fit(x_num_raw[tr_idx])
        x_num = scaler.transform(x_num_raw).astype(np.float32)

        artifacts = PreprocessArtifacts(
            user_id_mapping=user_map,
            item_id_mapping=item_map,
            cat_encoders=cat_encoders,
            scaler=scaler,
            numerical_cols=self.numerical_cols,
            categorical_cols=self.categorical_cols,
            medians=medians,
        )
        splits = DatasetSplits(
            train_user=user_enc[tr_idx], train_item=item_enc[tr_idx],
            train_cat=x_cat[tr_idx], train_num=x_num[tr_idx], train_y=y[tr_idx],
            val_user=user_enc[va_idx], val_item=item_enc[va_idx],
            val_cat=x_cat[va_idx], val_num=x_num[va_idx], val_y=y[va_idx],
        )
        return splits, artifacts

    def _split(self, n: int) -> tuple[np.ndarray, np.ndarray]:
        """``train_test_split(arange(n), test_size, random_state)`` → (train, test)."""
        n_test = math.ceil(self.test_size * n)
        perm = np.random.RandomState(self.split_seed).permutation(n)
        return perm[n_test:], perm[:n_test]


def scaled_numericals(artifacts: PreprocessArtifacts, table: dict, n: int) -> np.ndarray:
    """Numericals filled with the train medians, then min-max scaled with
    the train scaler → ``[n, F]`` f32."""
    raw = np.stack(
        [table[c].astype(np.float64) for c in artifacts.numerical_cols], axis=1
    ).reshape(n, len(artifacts.numerical_cols))
    med = np.asarray([artifacts.medians[c] for c in artifacts.numerical_cols])
    raw = np.where(np.isnan(raw), med, raw)
    return artifacts.scaler.transform(raw).astype(np.float32)


def drop_missing_categories(table: dict, categorical_cols) -> dict:
    """The rows with every categorical present (``df.dropna(subset=…)``)."""
    keep = np.ones(n_rows(table), dtype=bool)
    for col in categorical_cols:
        keep &= ~np.array([isna(v) for v in table[col].tolist()], dtype=bool)
    return take(table, keep)


def transform_with_artifacts(artifacts: PreprocessArtifacts, table: dict) -> dict:
    """Encode a labelled review table with saved artifacts, no refit (the
    standalone evaluation path): rows with a missing categorical dropped,
    the train vocabularies with the serving fallbacks (unknown user →
    ``n_users // 2``, unknown item or category → 0), numericals filled with
    the train medians and scaled with the train scaler → ``{"user", "item",
    "cat", "num"}`` arrays, and ``"y"`` where the target column is present."""
    table = drop_missing_categories(table, artifacts.categorical_cols)
    n = n_rows(table)
    users = map_fill(table[schema.USER_COL], artifacts.user_id_mapping, artifacts.unknown_user_id)
    items = map_fill(table[schema.ITEM_COL], artifacts.item_id_mapping, 0)
    cats = [map_fill(table[col], artifacts.cat_encoders[col], 0).astype(np.int32)
            for col in artifacts.categorical_cols]
    out = {
        "user": users.astype(np.int32).reshape(n),
        "item": items.astype(np.int32).reshape(n),
        "cat": np.stack(cats, axis=1) if cats else np.zeros((n, 0), np.int32),
        "num": scaled_numericals(artifacts, table, n),
    }
    if schema.TARGET_COL in table:
        out["y"] = table[schema.TARGET_COL].astype(np.float32)
    return out


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
    return item_codes, x_cat, scaled_numericals(artifacts, items, n)


def encode_items_for_ranking(artifacts: PreprocessArtifacts, items: dict, user_id: int) -> tuple:
    """Serve-time featurization of a table of item rows for one user →
    (users, items, categorical codes, scaled numericals): an unknown user
    gets ``artifacts.unknown_user_id``, an unknown item 0, an unknown
    category 0, as the reference's serve path falls back."""
    internal_user = artifacts.user_id_mapping.get(user_id, artifacts.unknown_user_id)
    item_codes, x_cat, x_num = encode_item_features(artifacts, items)
    return np.full(len(item_codes), internal_user, dtype=np.int32), item_codes, x_cat, x_num
