"""CSV ingest: load, rename, noise-filter (counterpart of
``hhrs_tpu/data/ingest.py``, on :mod:`hhrs_tpu_torch.data.table`).

Both loaders read through ``engine``, as the JAX package's do:

* ``"auto"`` (the default): the native C++ reader (``runtime/csv.py``),
  strictly; where its parse could differ from the Python reader's
  (:class:`~hhrs_tpu_torch.runtime.csv.NativeParseMismatch`), or the
  library cannot be built, the Python reader ``data/table.py::read_csv``
  with a warning (JAX falls back to pandas the same way);
* ``"native"``: the native reader, not strictly (counted divergences only
  warn); raises when the library is unavailable;
* ``"python"``: ``data/table.py::read_csv``.
"""

from __future__ import annotations

import logging
import os

from hhrs_tpu_torch.data import schema
from hhrs_tpu_torch.data.table import n_rows, read_csv, take

log = logging.getLogger(__name__)

ENGINES = ("auto", "native", "python")


def read_table(path: str, engine: str = "auto") -> dict:
    """``path`` read by ``engine`` (module docstring) → a table."""
    if engine not in ENGINES:
        raise ValueError(f"unknown CSV engine {engine!r}; expected one of {ENGINES}")
    if engine == "python":
        return read_csv(path)
    from hhrs_tpu_torch import runtime
    from hhrs_tpu_torch.runtime.csv import NativeParseMismatch, read_csv_native

    if not runtime.native_available():
        if engine == "native":
            raise RuntimeError(f"native CSV reader not available: {runtime.build_error()}")
        log.warning("native CSV reader not available (%s); reading %s with the Python reader",
                    runtime.build_error(), path)
        return read_csv(path)
    try:
        return read_csv_native(path, strict=engine == "auto")
    except NativeParseMismatch as e:
        if engine == "native":
            raise
        log.warning("%s; falling back to the Python reader", e)
        return read_csv(path)


def load_reviews_csv(path: str, engine: str = "auto") -> dict:
    """Load the reviews CSV, validate its columns, and rename
    guest_id → user_id and hotel_id → item_id."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    table = read_table(path, engine)
    missing = [c for c in schema.REVIEWS_CSV_COLUMNS if c not in table]
    if missing:
        raise ValueError(f"reviews CSV missing columns {missing}")
    renames = {schema.RAW_USER_COL: schema.USER_COL, schema.RAW_ITEM_COL: schema.ITEM_COL}
    table = {renames.get(name, name): col for name, col in table.items()}
    log.info("loaded %d review rows from %s", n_rows(table), path)
    return table


def load_friendships_csv(path: str, engine: str = "auto") -> dict:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    table = read_table(path, engine)
    missing = [c for c in schema.FRIEND_COLS if c not in table]
    if missing:
        raise ValueError(f"friendships CSV missing columns {missing}")
    return table


def noise_filter(table: dict, positive: float = 8.0, negative: float = 4.0) -> dict:
    """Keep only confidently-labelled rows (rating >= positive or <= negative)."""
    r = table["rating_overall"].astype(float)
    return take(table, (r >= positive) | (r <= negative))
