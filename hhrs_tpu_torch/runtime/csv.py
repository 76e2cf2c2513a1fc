"""The port's table over the native CSV reader (counterpart of
``hhrs_tpu/runtime/csv.py``, which builds a pandas frame).

:func:`read_csv_native` returns the table ``data/table.py::read_csv``
returns for this project's files, a dict of numpy columns typed as it
types them: integer columns with no empty cell ``int64``, other numeric
columns ``float64`` (empty and NA cells NaN), anything else an ``object``
array of ``str`` with NaN for NA cells.

The native reader types a column from its first 1,000 rows, so a file
outside this project's schema could come out otherwise than the Python
reader reads it: a later non-numeric token in a numeric column becomes NaN,
a row of the wrong field count is dropped. Both are counted by the C++
side. With ``strict=True`` each raises :class:`NativeParseMismatch`, and so
does every case the counters cannot see: a non-'.' decimal point in the
locale, an empty or single-column file, duplicate or BOM-carrying headers,
non-UTF-8 bytes, NUL bytes in a cell, integers beyond 2⁵³ (the float64
round trip loses them) and string columns whose sampled tokens all look
numeric, boolean or NA (the reader's typing and Python's may part there).
``data/ingest.py``'s ``auto`` mode reads strictly and falls back to the
Python reader on any of these; without ``strict`` the counted cases only
warn.
"""

from __future__ import annotations

import locale
import logging

import numpy as np

from hhrs_tpu_torch.data.table import NA_VALUES
from hhrs_tpu_torch.runtime import build_error, get_lib

log = logging.getLogger(__name__)


class NativeParseMismatch(RuntimeError):
    """The native parse could differ from the Python reader's; read the file
    with ``data/table.py::read_csv`` instead."""


# Tokens that make a column typed (NA or boolean) rather than a string
# column when every sampled token of it is one of these or a number.
_TYPED_TOKENS = {
    "", "nan", "na", "n/a", "null", "none", "true", "false",
    "#n/a", "#n/a n/a", "#na", "-nan", "<na>",
}


def _looks_typed(values: np.ndarray) -> bool:
    """True if every sampled string of a column is numeric, boolean or NA."""
    sample = [v for v in values[:1000] if isinstance(v, str)]
    if not sample:
        return False
    for v in sample:
        t = v.strip().lower()
        if t in _TYPED_TOKENS:
            continue
        try:
            float(t)
        except ValueError:
            return False
    return True


def read_csv_native(path: str, n_threads: int = 0, strict: bool = False) -> dict:
    """Parse ``path`` with the C++ reader on ``n_threads`` threads (0: one a
    core) → the table; raises RuntimeError when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native CSV reader not available: {build_error()}")
    if (locale.localeconv().get("decimal_point") or ".") != ".":
        raise NativeParseMismatch("non-'.' LC_NUMERIC locale (strtod reads it; Python's float does not)")

    handle = lib.csv_load(str(path).encode(), n_threads)
    try:
        err = lib.csv_error(handle)
        if err:
            raise RuntimeError(f"csv_load: {err.decode()}")
        n = lib.csv_n_rows(handle)
        n_cols = lib.csv_n_cols(handle)
        if n == 0 or n_cols <= 1:
            raise NativeParseMismatch("empty or single-column CSV")
        try:
            names = [lib.csv_col_name(handle, i).decode() for i in range(n_cols)]
        except UnicodeDecodeError as e:
            raise NativeParseMismatch(f"non-UTF-8 header bytes: {e}") from e
        if len(set(names)) != len(names):
            raise NativeParseMismatch("duplicate header names")
        if names[0].startswith("\ufeff"):
            raise NativeParseMismatch("UTF-8 BOM in the header")
        nul_cells = int(lib.csv_n_nul_cells(handle))
        if nul_cells:  # a NUL cannot cross the '\n'-joined vocabulary at all
            raise NativeParseMismatch(f"{nul_cells} cell(s) contain NUL bytes")
        bad_rows = int(lib.csv_n_bad_rows(handle))
        coerced = {names[i]: c for i in range(n_cols) if (c := int(lib.csv_col_n_coerced(handle, i)))}
        if bad_rows or coerced:
            msg = (f"native CSV parse of {path} differs from the Python reader's: {bad_rows} row(s) dropped "
                   f"(field-count mismatch), non-numeric tokens coerced to NaN per column: {coerced or '{}'}")
            if strict:
                raise NativeParseMismatch(msg)
            log.warning("%s", msg)
        table = {}
        for i, name in enumerate(names):
            if lib.csv_col_kind(handle, i) == 0:
                col = np.array(np.ctypeslib.as_array(lib.csv_col_f64(handle, i), shape=(n,)), dtype=np.float64)
                if lib.csv_col_int_like(handle, i):  # every token plain integer text: int64
                    if np.any(np.abs(col) >= 2.0**53):
                        msg = f"column {name!r} has integers beyond 2^53 (the float64 round trip loses them)"
                        if strict:
                            raise NativeParseMismatch(msg)
                        log.warning("%s; keeping float64", msg)
                    else:
                        col = col.astype(np.int64)
                table[name] = col
                continue
            codes = np.array(np.ctypeslib.as_array(lib.csv_col_codes(handle, i), shape=(n,)), dtype=np.int32)
            nv = lib.csv_col_vocab_size(handle, i)
            try:
                vocab = lib.csv_col_vocab(handle, i).decode().split("\n") if nv else []
            except UnicodeDecodeError as e:
                raise NativeParseMismatch(f"non-UTF-8 cell bytes: {e}") from e
            if len(vocab) != nv:
                raise NativeParseMismatch(f"column {name!r} vocabulary cut in transit ({len(vocab)} != {nv})")
            col = np.asarray(vocab + [np.nan], dtype=object)[codes]  # code -1 → the NaN slot
            if strict and _looks_typed(col):
                raise NativeParseMismatch(f"column {name!r} read as strings, but every sampled token is "
                                          "numeric, boolean or NA")
            na = np.asarray([v in NA_VALUES for v in vocab] + [False])
            if na.any():
                col[na[codes]] = np.nan
            table[name] = col
        return table
    finally:
        lib.csv_free(handle)
