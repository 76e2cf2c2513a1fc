"""CSV ingest: load, rename, noise-filter (counterpart of
``hhrs_tpu/data/ingest.py``, on :mod:`hhrs_tpu_torch.data.table`)."""

from __future__ import annotations

import logging
import os

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import n_rows, read_csv, take

log = logging.getLogger(__name__)


def load_reviews_csv(path: str) -> dict:
    """Load the reviews CSV, validate its columns, and rename
    guest_id → user_id and hotel_id → item_id."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    table = read_csv(path)
    missing = [c for c in schema.REVIEWS_CSV_COLUMNS if c not in table]
    if missing:
        raise ValueError(f"reviews CSV missing columns {missing}")
    renames = {schema.RAW_USER_COL: schema.USER_COL, schema.RAW_ITEM_COL: schema.ITEM_COL}
    table = {renames.get(name, name): col for name, col in table.items()}
    log.info("loaded %d review rows from %s", n_rows(table), path)
    return table


def load_friendships_csv(path: str) -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    table = read_csv(path)
    missing = [c for c in schema.FRIEND_COLS if c not in table]
    if missing:
        raise ValueError(f"friendships CSV missing columns {missing}")
    return table


def noise_filter(table: dict, positive: float = 8.0, negative: float = 4.0) -> dict:
    """Keep only confidently-labelled rows (rating >= positive or <= negative)."""
    r = table["rating_overall"].astype(float)
    return take(table, (r >= positive) | (r <= negative))
