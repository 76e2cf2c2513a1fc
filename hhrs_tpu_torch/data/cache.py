"""Preprocessed-dataset cache (counterpart of ``hhrs_tpu/data/cache.py``).

The encoded arrays are fixed by the CSV's contents and the preprocessing
knobs, so a run saves them once, as one ``.npz`` and the
``PreprocessArtifacts`` JSON, and a later run with the same key skips the
CSV parse, the features, the encoders and the split. The key hashes the
CSV's path, size and mtime, the knobs, and the source of the port's
preprocessing modules, so a change to that code misses the old entries.
Stale entries are never hit again; the directory can be deleted freely.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import zipfile

import numpy as np

from hhrs_tpu_torch.data.preprocess import DatasetSplits, PreprocessArtifacts

log = logging.getLogger(__name__)

_SPLIT_FIELDS = (
    "train_user", "train_item", "train_cat", "train_num", "train_y",
    "val_user", "val_item", "val_cat", "val_num", "val_y",
)


def _code_version() -> str:
    """Hash of the sources that turn a CSV into the cached arrays."""
    import hhrs_tpu_torch.data.features as features
    import hhrs_tpu_torch.data.ingest as ingest
    import hhrs_tpu_torch.data.preprocess as preprocess
    import hhrs_tpu_torch.data.table as table

    h = hashlib.sha1()
    for mod in (features, ingest, preprocess, table):
        with open(mod.__file__, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:12]


def cache_key(csv_path: str, cfg_knobs: dict) -> str:
    st = os.stat(csv_path)
    blob = json.dumps(
        {"path": os.path.abspath(csv_path), "size": st.st_size,
         "mtime_ns": st.st_mtime_ns, "code": _code_version(), **cfg_knobs},
        sort_keys=True,
    )
    return hashlib.sha1(blob.encode()).hexdigest()[:16]


def save(cache_dir: str, key: str, splits: DatasetSplits, artifacts: PreprocessArtifacts) -> None:
    os.makedirs(cache_dir, exist_ok=True)
    np.savez(os.path.join(cache_dir, f"{key}.npz"), **{f: getattr(splits, f) for f in _SPLIT_FIELDS})
    artifacts.save(os.path.join(cache_dir, f"{key}.preproc.json"))
    log.info("dataset cache write: %s/%s", cache_dir, key)


def load(cache_dir: str, key: str):
    """``(splits, artifacts)`` on a hit; None on a miss or an unreadable entry."""
    npz_path = os.path.join(cache_dir, f"{key}.npz")
    pre_path = os.path.join(cache_dir, f"{key}.preproc.json")
    if not (os.path.exists(npz_path) and os.path.exists(pre_path)):
        return None
    try:
        with np.load(npz_path) as z:
            splits = DatasetSplits(**{f: z[f] for f in _SPLIT_FIELDS})
        artifacts = PreprocessArtifacts.load(pre_path)
    except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:  # a torn entry must not end the run
        log.warning("dataset cache read failed (%s); re-preprocessing", e)
        return None
    log.info("dataset cache hit: %s/%s", cache_dir, key)
    return splits, artifacts
