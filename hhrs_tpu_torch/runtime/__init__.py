"""Native host runtime: the multithreaded mmap CSV reader
(``csrc/csv_reader.cpp``, a copy of ``hhrs_tpu/runtime/csv_reader.cpp``)
behind ctypes. Counterpart of ``hhrs_tpu/runtime/__init__.py``.

The library is built at first use with the host compiler (``g++ -O3
-std=c++17 -fPIC -shared -pthread``; ``$CXX`` overrides the compiler) into
``build/hhrs_tpu_torch/`` at the repository root, named by a hash of the
source and flags, by ``ops/cuda_build.py``'s route for the CUDA kernels:
an edited source rebuilds, an unchanged one is reused, and the library is
written to a temporary file and renamed into place, so processes that
build at once (test workers) never load a half-written one. With no
compiler, or a failed build, :func:`get_lib` returns None and
:func:`build_error` says why: ``data/ingest.py``'s ``auto`` mode then reads
with the Python reader, ``native`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import threading
from pathlib import Path

from hhrs_tpu_torch.ops.cuda_build import BUILD_DIR, CSRC_DIR, compile_into

log = logging.getLogger(__name__)

SOURCE = "csv_reader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib = None
_error: str | None = None


def library_path() -> Path:
    h = hashlib.sha256((CSRC_DIR / SOURCE).read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libhhrs_runtime_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/csv_reader.cpp`` unless the hash-named library exists
    → its path. Raises when there is no compiler or the build fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError(f"no host C++ compiler ({os.environ.get('CXX', 'g++')}) to build {SOURCE}")
    compile_into(out, [cxx, *CXX_FLAGS], [CSRC_DIR / SOURCE])
    return out


def get_lib():
    """The loaded library, built if needed (once per process); None when it
    cannot be built or loaded (:func:`build_error` says why)."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
            _wire_symbols(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
            log.info("native CSV reader unavailable: %s", e)
            return None
        _lib = lib
        return _lib


def build_error() -> str | None:
    """Why :func:`get_lib` returned None, or None."""
    return _error


def native_available() -> bool:
    return get_lib() is not None


def _wire_symbols(lib) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.csv_load.restype = p
    lib.csv_load.argtypes = [ctypes.c_char_p, i]
    lib.csv_free.argtypes = [p]
    lib.csv_error.restype = ctypes.c_char_p
    lib.csv_error.argtypes = [p]
    for name in ("csv_n_rows", "csv_n_bad_rows", "csv_n_nul_cells"):
        getattr(lib, name).restype = i64
        getattr(lib, name).argtypes = [p]
    lib.csv_col_n_coerced.restype = i64
    lib.csv_col_n_coerced.argtypes = [p, i]
    lib.csv_n_cols.restype = i
    lib.csv_n_cols.argtypes = [p]
    lib.csv_col_name.restype = ctypes.c_char_p
    lib.csv_col_name.argtypes = [p, i]
    for name in ("csv_col_kind", "csv_col_int_like", "csv_col_vocab_size"):
        getattr(lib, name).restype = i
        getattr(lib, name).argtypes = [p, i]
    lib.csv_col_f64.restype = ctypes.POINTER(ctypes.c_double)
    lib.csv_col_f64.argtypes = [p, i]
    lib.csv_col_codes.restype = ctypes.POINTER(ctypes.c_int32)
    lib.csv_col_codes.argtypes = [p, i]
    lib.csv_col_vocab.restype = ctypes.c_char_p
    lib.csv_col_vocab.argtypes = [p, i]
