"""Build and load the hand-written CUDA kernels.

Each kernel is a ``.cu`` file under the package's ``csrc/`` with a plain
C interface; code two kernels share is a ``.cuh`` header there.  At
first use it is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/torch_kernels/`` at the root of the
checkout and loaded with ``ctypes``.  The library's file name carries a
hash of its sources, the shared headers and the flags, so an edited
source or header rebuilds.  A failed build raises: no route falls back to the kernel's
plain PyTorch version on a CUDA tensor.  Each library has its own lock,
so libraries built from several threads compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "digest", "load_library", "check"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_locks_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in (home, "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the CUDA kernels cannot be built"
    )


def digest(sources: tuple[str, ...]) -> str:
    """The build key of a library: a hash of the flags, of
    ``csrc/<sources>`` and of every shared header ``csrc/*.cuh``, which
    any source may include, so an edited header rebuilds each library."""
    paths = [CSRC / s for s in sources] + sorted(CSRC.glob("*.cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def load_library(name: str, sources: tuple[str, ...]) -> ctypes.CDLL:
    """Compile (once per :func:`digest`) and load ``csrc/<sources>`` as
    ``lib<name>-<digest>.so``.  A library loaded once is returned again
    without reading its sources: the wrappers call this on every launch."""
    key = (name, sources)
    lib = _loaded.get(key)
    if lib is not None:
        return lib
    paths = [CSRC / s for s in sources]
    lib_path = BUILD_DIR / f"lib{name}-{digest(sources)}.so"
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if key in _loaded:
            return _loaded[key]
        if not lib_path.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, paths)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed building {name}:\n{res.stderr}"
                    )
                os.replace(tmp, lib_path)  # atomic: no half-written .so
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(lib_path))
        lib.petal_error_string.argtypes = [ctypes.c_int]
        lib.petal_error_string.restype = ctypes.c_char_p
        _loaded[key] = lib
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point
    (a refused launch never runs, and a later synchronize would not
    report it)."""
    if status != 0:
        msg = lib.petal_error_string(status).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError_t {status})")
