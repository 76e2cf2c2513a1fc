"""A small columnar table: the port's stand-in for the pandas frames.

A table is a ``dict`` of column name → 1-D numpy array, every column of one
length. :func:`read_csv` reproduces the ``pd.read_csv`` typing the serving
path relies on: a column of integer literals with no empty cell is
``int64``; a column whose cells all parse as floats (empty / NA cells → NaN)
is ``float64``; anything else is an ``object`` array of ``str`` with NaN for
NA cells. The helpers keep pandas' order semantics: first appearance for
``drop_duplicates`` / ``unique``, and NaN treated as one value.
"""

from __future__ import annotations

import csv
import re

import numpy as np

# pandas' default NA spellings (read_csv ``na_values`` default)
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})

_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")
_NAN_KEY = object()  # one dictionary key for every NaN


def _parse_column(cells: list) -> np.ndarray:
    na = [c in NA_VALUES for c in cells]
    if not any(na) and all(_INT_RE.match(c) for c in cells):
        try:
            return np.array([int(c) for c in cells], dtype=np.int64)
        except OverflowError:
            pass
    if all(n or "_" not in c for c, n in zip(cells, na)):
        try:
            return np.array(
                [np.nan if n else float(c) for c, n in zip(cells, na)], dtype=np.float64
            )
        except ValueError:
            pass
    out = np.empty(len(cells), dtype=object)
    out[:] = [np.nan if n else c for c, n in zip(cells, na)]
    return out


def read_csv(path: str) -> dict:
    """Read a comma-separated file with a header row into a table."""
    with open(path, newline="") as f:
        reader = csv.reader(f)
        try:
            header = next(reader)
        except StopIteration:
            raise ValueError(f"{path}: empty CSV (no header row)") from None
        rows = []
        for line_no, row in enumerate(reader, start=2):
            if not row:
                continue  # pandas skips blank lines
            if len(row) > len(header):
                raise ValueError(
                    f"{path}:{line_no}: {len(row)} fields, header has {len(header)}"
                )
            rows.append(row + [""] * (len(header) - len(row)))
    columns = list(zip(*rows)) if rows else [() for _ in header]
    return {name: _parse_column(list(cells)) for name, cells in zip(header, columns)}


def n_rows(table: dict) -> int:
    return len(next(iter(table.values()))) if table else 0


def take(table: dict, rows) -> dict:
    """Rows selected by an index array or a boolean mask, in that order."""
    return {name: col[rows] for name, col in table.items()}


def isna(value) -> bool:
    """pandas.isna for one scalar: None or a float NaN."""
    return value is None or (isinstance(value, float) and value != value)


def first_occurrence(values: np.ndarray) -> np.ndarray:
    """Row index of the first appearance of each distinct value, ascending
    (the rows ``drop_duplicates`` keeps; NaNs count as one value)."""
    seen: dict = {}
    for i, v in enumerate(values.tolist()):
        seen.setdefault(_NAN_KEY if isna(v) else v, i)
    return np.fromiter(seen.values(), dtype=np.int64, count=len(seen))


def unique_first(values: np.ndarray, dropna: bool = False) -> np.ndarray:
    """Distinct values in order of first appearance (``pd.unique``)."""
    if dropna:
        values = values[~np.array([isna(v) for v in values.tolist()], dtype=bool)]
    return values[first_occurrence(values)]


def map_fill(values: np.ndarray, mapping: dict, fill) -> np.ndarray:
    """``series.map(mapping).fillna(fill)``: unknown and NaN values → fill."""
    return np.array([mapping.get(v, fill) for v in values.tolist()])
