"""Build a CUDA source of this package into a shared library and load it.

Route: ``nvcc`` by hand into a library with a plain C interface, loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). The
library lands in ``build/hhrs_tpu_torch/`` at the repository root, named
by a hash of its sources and flags, so an edited source rebuilds and an
unchanged one is reused. A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "hhrs_tpu_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the CUDA "
        "kernels of hhrs_tpu_torch are built from source at first use"
    )


def library_path(name: str, sources: list) -> Path:
    h = hashlib.sha256()
    for src in sources:
        h.update((CSRC_DIR / src).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(name: str, sources: list) -> Path:
    """Compile ``csrc/<sources>`` into ``lib<name>_<hash>.so`` unless that
    file exists. The ``ptxas`` report (registers, shared memory, spills)
    is kept beside it as ``.log``."""
    out = library_path(name, sources)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *[str(CSRC_DIR / s) for s in sources]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {name}:\n{proc.stdout}\n{proc.stderr}"
        )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    return out


def load(name: str, sources: list) -> ctypes.CDLL:
    """Build if needed, then load; callers keep the handle (loading is once
    per process per library)."""
    return ctypes.CDLL(str(build(name, sources)))
