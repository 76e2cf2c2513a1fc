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
    log = compile_into(out, [find_nvcc(), *NVCC_FLAGS], [CSRC_DIR / s for s in sources])
    out.with_suffix(".log").write_text(log)
    return out


def compile_into(out: Path, compiler: list, sources: list) -> str:
    """Run ``compiler ... -o <tmp> sources`` and rename the result to
    ``out`` (atomic: a concurrent build, such as another test worker's,
    sees all or nothing) → the compiler's output; raises when it fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run([*compiler, "-o", tmp, *map(str, sources)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler[0]} failed ({proc.returncode}) building {out.name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def load(name: str, sources: list) -> ctypes.CDLL:
    """Build if needed, then load; callers keep the handle (loading is once
    per process per library)."""
    return ctypes.CDLL(str(build(name, sources)))
