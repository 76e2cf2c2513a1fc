"""The native CSV reader of the port (ROADMAP A13): ``runtime/csv.py`` over
``csrc/csv_reader.cpp``, built by ``runtime/__init__.py`` with the host
compiler, against the port's Python reader ``data/table.py::read_csv``
(exact: the same columns, dtypes and values), and ``data/ingest.py``'s
``engine=`` modes. The cases of ``tests/test_runtime.py``, held here to the
Python reader instead of pandas; that file keeps holding the JAX reader to
pandas.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import pytest

from hhrs_tpu_torch import runtime
from hhrs_tpu_torch.data import ingest
from hhrs_tpu_torch.data.synthetic import write_synthetic_dataset
from hhrs_tpu_torch.data.table import isna, read_csv
from hhrs_tpu_torch.runtime.csv import NativeParseMismatch, read_csv_native

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "data"


@pytest.fixture(scope="module", autouse=True)
def native_library():
    """The library builds here (g++ is part of this image and of the card
    machine's): a failed build fails the module rather than skipping it."""
    assert runtime.get_lib() is not None, runtime.build_error()


def assert_tables_equal(want: dict, got: dict) -> None:
    """Column names in order, dtypes, and values (NaN equal to NaN; object
    cells equal as Python objects of one type)."""
    assert list(want) == list(got)
    for name in want:
        a, b = want[name], got[name]
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        assert a.shape == b.shape, name
        if a.dtype == object:
            for x, y in zip(a.tolist(), b.tolist()):
                assert (isna(x) and isna(y)) or (type(x) is type(y) and x == y), (name, x, y)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def write(tmp_path, name: str, content) -> str:
    p = tmp_path / name
    if isinstance(content, bytes):
        p.write_bytes(content)
    else:
        p.write_text(content)
    return str(p)


@pytest.mark.parametrize("name", ["hackathon_augmented_data.csv", "friendships.csv"])
def test_native_table_equals_the_python_readers_on_data(name):
    path = str(DATA / name)
    assert_tables_equal(read_csv(path), read_csv_native(path, strict=True))


def test_native_table_equals_the_python_readers_on_a_synthetic_set(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_users=300, n_items=100, n_reviews=5000, seed=9)
    for name in ("hackathon_augmented_data.csv", "friendships.csv"):
        path = str(tmp_path / name)
        assert_tables_equal(read_csv(path), read_csv_native(path, strict=True))


def test_edge_cases(tmp_path):
    """CRLF rows, a quoted cell, an empty numeric cell (→ float64 NaN), an
    empty string cell (→ NaN)."""
    path = write(tmp_path, "edge.csv", 'id,price,city,note\r\n1,10.5,"Sochi",hello\r\n2,,Moscow,\r\n'
                                       '3,-7.25,Sochi,world\r\n')
    got = read_csv_native(path, strict=True)
    assert_tables_equal(read_csv(path), got)
    assert got["id"].dtype == np.int64 and got["price"].dtype == np.float64
    assert np.isnan(got["price"][1]) and isna(got["note"][1]) and got["city"][0] == "Sochi"


def test_na_tokens_hex_doubled_quotes_and_bare_cr(tmp_path):
    """NA spellings among strings become NaN (case-sensitive: 'Null' stays),
    hex tokens stay strings, doubled quotes unescape, a bare \\r ends a row."""
    cases = {
        "na_mixed.csv": "a,b\n1,Paris\n2,NA\n3,London\n4,null\n5,Null\n",
        "hex.csv": "a,b\n1,0x1A\n2,0xFF\n",
        "quotes.csv": 'a,b\n1,"he said ""hi"""\n2,plain\n',
        "bare_cr.csv": b"a,b\n1,x\r2,y\n3,z\n",
    }
    for name, content in cases.items():
        path = write(tmp_path, name, content)
        assert_tables_equal(read_csv(path), read_csv_native(path, strict=True))
    got = read_csv_native(str(tmp_path / "na_mixed.csv"), strict=True)["b"]
    assert [isna(v) for v in got] == [False, True, False, True, False]
    assert read_csv_native(str(tmp_path / "hex.csv"), strict=True)["b"].tolist() == ["0x1A", "0xFF"]
    assert read_csv_native(str(tmp_path / "quotes.csv"), strict=True)["b"].tolist() == ['he said "hi"', "plain"]
    assert read_csv_native(str(tmp_path / "bare_cr.csv"), strict=True)["a"].tolist() == [1, 2, 3]


STRICT_REFUSALS = {
    "na_tokens": "a,b\n" + "\n".join(f"{i},NA" for i in range(1200)),
    "bools": "a,b\n" + "\n".join(f"{i},True" for i in range(1200)),
    "big_ints": "a,b\n9007199254740993,1\n9007199254740995,2\n",
    "dup_header": "a,a\n1,2\n",
    "bom": "\ufeffa,b\n1,2\n",
    "empty": "a,b\n",
    "single_column": "a\n1\n2\n",
    "late_string": "a,b\n" + "\n".join(f"{i},{i}" for i in range(1200)) + "\n1200,x\n",
    "short_row": "a,b,c\n1,2,3\n4,5\n",
    "leading_space_ints": "a,b\n1, 2\n3, 4\n",
    "trailing_space_floats": "a,b\n1,2.5 \n3,4.5 \n",
    "quoted_comma": 'a,b\n1,"x,y"\n2,z\n',
    "binary": b"\x1f\x8b\x08\x00junk\xff\xfe\n",
    "nul": b"a,b\n1,foo\x00bar\n2,x\n3,y\n",
}


@pytest.mark.parametrize("label", sorted(STRICT_REFUSALS))
def test_strict_mode_refuses_what_could_differ_and_auto_falls_back(tmp_path, label, caplog):
    """Each case raises in strict mode; ``auto`` ingest then reads the file
    with the Python reader (its table, exactly) wherever that reader can."""
    path = write(tmp_path, f"{label}.csv", STRICT_REFUSALS[label])
    with pytest.raises((NativeParseMismatch, RuntimeError)):
        read_csv_native(path, strict=True)
    try:
        want = read_csv(path)
    except (ValueError, UnicodeDecodeError):
        return  # the Python reader cannot read it either
    with caplog.at_level(logging.WARNING, logger="hhrs_tpu_torch.data.ingest"):
        got = ingest.read_table(path, "auto")
    assert_tables_equal(want, got)
    assert "falling back to the Python reader" in caplog.text


def test_nul_cells_are_refused_even_when_not_strict(tmp_path):
    path = write(tmp_path, "nul.csv", STRICT_REFUSALS["nul"])
    with pytest.raises(NativeParseMismatch):
        read_csv_native(path, strict=False)


def test_non_strict_big_ints_stay_float64(tmp_path):
    """Beyond 2^53 (and 2^63) a non-strict read keeps float64 with a warning,
    never a wrapped int64."""
    got = read_csv_native(write(tmp_path, "big.csv", "a,b\n99999999999999999999,1\n12345678901234567890,2\n"))
    assert got["a"].dtype == np.float64 and (got["a"] > 0).all()


def test_thread_invariance(tmp_path):
    write_synthetic_dataset(str(tmp_path), n_users=200, n_items=80, n_reviews=3000, seed=4)
    path = str(tmp_path / "hackathon_augmented_data.csv")
    one = read_csv_native(path, n_threads=1, strict=True)
    for n in (2, 7, 0):
        assert_tables_equal(one, read_csv_native(path, n_threads=n, strict=True))


@pytest.mark.parametrize("loader", ["load_reviews_csv", "load_friendships_csv"])
def test_loaders_read_natively_with_python_parity(loader):
    name = "hackathon_augmented_data.csv" if loader == "load_reviews_csv" else "friendships.csv"
    load = getattr(ingest, loader)
    want = load(str(DATA / name), engine="python")
    assert_tables_equal(want, load(str(DATA / name), engine="native"))
    assert_tables_equal(want, load(str(DATA / name)))  # auto, the default


def test_auto_falls_back_and_native_raises_without_the_library(tmp_path, monkeypatch, caplog):
    path = str(DATA / "friendships.csv")
    monkeypatch.setattr(runtime, "get_lib", lambda: None)
    monkeypatch.setattr(runtime, "_error", "no host C++ compiler (g++)")
    with caplog.at_level(logging.WARNING, logger="hhrs_tpu_torch.data.ingest"):
        assert_tables_equal(read_csv(path), ingest.load_friendships_csv(path))
    assert "not available" in caplog.text
    with pytest.raises(RuntimeError, match="not available"):
        ingest.load_friendships_csv(path, engine="native")
    with pytest.raises(ValueError, match="unknown CSV engine"):
        ingest.read_table(path, "pandas")


def test_library_is_hash_named_under_build_and_reused():
    """The library lives in build/hhrs_tpu_torch/, named by the source's and
    flags' hash; a second build call reuses it."""
    path = runtime.library_path()
    assert path.parent == REPO / "build" / "hhrs_tpu_torch" and path.exists()
    mtime = path.stat().st_mtime_ns
    assert runtime.build() == path and path.stat().st_mtime_ns == mtime
