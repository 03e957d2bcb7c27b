"""ctypes bindings of the host C++ factorization core — the port's own
counterpart of ``petal_decomposition_tpu/utils/native.py``, with its
signatures (:func:`jacobi_svd`, :func:`jacobi_eigh`, :func:`qr`,
:func:`lu_pl`, all float64 numpy in and out).

The core is the repository's ``native/petal_native.cpp``.  At first use
it is compiled by ``g++`` with the flags of ``native/Makefile`` into
``build/native/`` at the root of the checkout (never into ``native/``),
as ``libpetal_native-<digest>.so``: the digest hashes the source, the
flags, this host's CPU (``-march=native`` code is the host's own) and
its C library, so an edited source, or a checkout moved to another
machine, rebuilds.  A
build is written to a temporary file and renamed into place, so
processes that build at once never load a half-written library.

:func:`available` reports whether the library loads.  Unlike the JAX
module, whose backend quietly falls back when the library is missing,
:func:`load` raises :class:`NativeError` naming the build error: the
``"native"`` backend and the host offload call it and so raise too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "load",
    "jacobi_svd",
    "jacobi_eigh",
    "qr",
    "lu_pl",
    "NativeError",
]

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "petal_native.cpp"
BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile's CXXFLAGS.
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
            "-Wall")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
_failed: dict[str, str] = {}


class NativeError(RuntimeError):
    pass


def _cpu_flags() -> str:
    """The host CPU's ISA extensions (Linux ``/proc/cpuinfo``); empty
    elsewhere, where the machine name alone keys the build."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return " ".join(sorted(line.split(":", 1)[1].split()))
    except OSError:
        pass
    return ""


@functools.lru_cache(maxsize=None)
def _digest(source: Path) -> str:
    """The build key of ``source``, read once a process (every native
    factorization asks for the library)."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(f"{platform.machine()}:{platform.libc_ver()}:{_cpu_flags()}"
             .encode())
    h.update(source.read_bytes())
    return h.hexdigest()[:16]


def _compile(source: Path, lib_path: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeError("building the native library failed: g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        res = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(source)],
                             capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise NativeError(
                f"building the native library from {source.name} failed:\n"
                f"{res.stderr}"
            )
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    dp = ctypes.POINTER(ctypes.c_double)
    i = ctypes.c_int
    lib.petal_jacobi_svd.argtypes = [dp, i, i, i, dp, dp, dp]
    lib.petal_jacobi_svd.restype = i
    lib.petal_jacobi_eigh.argtypes = [dp, i, i, dp, dp]
    lib.petal_jacobi_eigh.restype = i
    lib.petal_qr.argtypes = [dp, i, i, dp]
    lib.petal_qr.restype = i
    lib.petal_lu_pl.argtypes = [dp, i, i, dp]
    lib.petal_lu_pl.restype = i
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at first use; raises
    :class:`NativeError` naming the build error (a failed build is not
    retried for the same source in this process)."""
    source = SOURCE
    key = _digest(source)
    with _lock:
        if key in _loaded:
            return _loaded[key]
        if key in _failed:
            raise NativeError(_failed[key])
        lib_path = BUILD_DIR / f"libpetal_native-{key}.so"
        try:
            if not lib_path.is_file():
                _compile(source, lib_path)
            lib = _bind(ctypes.CDLL(str(lib_path)))
        except (NativeError, OSError, subprocess.TimeoutExpired) as e:
            _failed[key] = str(e)
            raise NativeError(str(e)) from None
        _loaded[key] = lib
        return lib


def available() -> bool:
    """Whether the library builds and loads."""
    try:
        load()
    except NativeError:
        return False
    return True


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def jacobi_svd(a: np.ndarray, max_sweeps: int = 0):
    """Thin SVD ``a = U diag(s) Vᵀ`` in float64: ``(u, s, vt)``.
    ``max_sweeps <= 0`` selects the library's default budget.

    >>> a = np.arange(12.0).reshape(4, 3) ** 1.5
    >>> u, s, vt = jacobi_svd(a)
    >>> bool(np.abs((u * s) @ vt - a).max() < 1e-10)
    True
    """
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    transposed = m < n
    if transposed:
        a = np.ascontiguousarray(a.T)
        m, n = n, m
    u = np.empty((m, n), np.float64)
    s = np.empty((n,), np.float64)
    vt = np.empty((n, n), np.float64)
    rc = lib.petal_jacobi_svd(
        _ptr(a), m, n, int(max_sweeps), _ptr(u), _ptr(s), _ptr(vt)
    )
    if rc != 0:
        raise NativeError("singular value decomposition did not converge")
    if transposed:
        return vt.T, s, u.T
    return u, s, vt


def jacobi_eigh(a: np.ndarray, max_sweeps: int = 0):
    """Symmetric eigendecomposition in float64, eigenvalues ascending:
    ``(w, v)``.  ``max_sweeps <= 0`` selects the library's default
    budget."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    n = a.shape[0]
    w = np.empty((n,), np.float64)
    v = np.empty((n, n), np.float64)
    rc = lib.petal_jacobi_eigh(_ptr(a), n, int(max_sweeps), _ptr(w), _ptr(v))
    if rc != 0:
        raise NativeError("eigendecomposition did not converge")
    return w, v


def qr(a: np.ndarray):
    """Economy Q (m × min(m, n)) by Householder reflections, float64."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    q = np.empty((m, min(m, n)), np.float64)
    if lib.petal_qr(_ptr(a), m, n, _ptr(q)) != 0:
        raise NativeError("qr factorization failed")
    return q


def lu_pl(a: np.ndarray):
    """Partial-pivot LU → P·L (m × min(m, n)), float64."""
    lib = load()
    a = np.ascontiguousarray(a, dtype=np.float64)
    m, n = a.shape
    pl = np.empty((m, min(m, n)), np.float64)
    if lib.petal_lu_pl(_ptr(a), m, n, _ptr(pl)) != 0:
        raise NativeError("lu factorization failed")
    return pl
