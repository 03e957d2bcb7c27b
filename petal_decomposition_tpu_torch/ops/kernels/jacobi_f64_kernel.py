"""K3: one-sided Jacobi SVD of a float64 panel in one launch.

The port of ``petal_decomposition_tpu/ops/pallas/jacobi_f64_kernel.py``
(``jacobi_svd_vmem_f64``).  A TPU has no native float64 vector
arithmetic, so the TPU kernel carries every value as a float32 (hi, lo)
pair through ``ops/pallas/df64.py``, at a unit roundoff of ≈2⁻⁴⁸.
Hopper has native float64 FMA, so ``df64.py`` is not ported: K3 is K2
(:mod:`.jacobi_kernels`) at float64, with the TPU kernel's constants
and K2's pair table.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel
``csrc/jacobi_svd_f64.cu`` (one block, every step and sweep in the
launch; the panel and V in device memory, resident in L2, because the
panels it serves exceed a block's 227 KB of shared memory); on a CPU
tensor it runs :func:`_jacobi_svd_plain_f64`, K2's plain version at
float64 with these constants.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .jacobi_kernels import _jacobi_svd_plain, _pair_table_on, _tol as _k2_tol

__all__ = ["jacobi_svd_vmem_f64", "supports", "build", "launches"]

# The TPU kernel's constants (jacobi_f64_kernel.py:34-35), shared by the
# kernel and its plain version.  The skip rule uses 2⁻⁴⁸, the TPU
# kernel's working precision, rather than float64's 2⁻⁵²: the extra
# rotations that 2⁻⁵² would apply sit below the stop rule's 2⁻⁴⁶ and
# change no certified digit, and the same rule keeps K3's rotations
# those of the kernel it replaces.  The stop rule, 2⁻⁴⁶·√max(m, n_pad),
# stays under the certificate's 2⁻⁴⁵·√dim (``linalg.convergence_tol``).
EPS = 2.0 ** -48
TOL_EPS = 2.0 ** -46

# The kernel's per-pair buffers hold 256 pairs.
_MAX_N_PAD = 512
# Padded panel plus V: keeps a direct launch to panels whose steps stay
# short (1000×64 needs 545 KB, the 1024×42 Bᵀ 358 KB, a 256×256 matrix
# 1 MiB, 512×512 exactly 4 MiB), all well inside the 50 MB L2.  Taller
# panels take the QR route in ``ops/jacobi.py`` with K3 on their R.
_MAX_BYTES = 4 << 20

launches = 0


def _panel_bytes(m: int, n: int) -> int:
    n_pad = n + (n % 2)
    return 8 * (m + n_pad) * n_pad


def supports(m: int, n: int, dtype) -> bool:
    """True when the kernel takes an m×n panel (m ≥ n, the caller's
    orientation): float64, n ≥ 2, n_pad = n + (n odd) ≤ 512, and the
    padded panel plus V, (m + n_pad)·n_pad·8 bytes, at most 4 MiB."""
    if dtype != torch.float64 or n < 2 or m < n:
        return False
    return n + (n % 2) <= _MAX_N_PAD and _panel_bytes(m, n) <= _MAX_BYTES


def _tol(m: int, n: int) -> float:
    return _k2_tol(m, n, TOL_EPS)


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_jacobi_svd_f64", ("jacobi_svd_f64.cu",))
    fn = lib.petal_jacobi_svd_f64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _jacobi_svd_plain_f64(a: torch.Tensor, max_sweeps: int):
    """The TPU kernel's arithmetic in vectorized PyTorch at float64:
    ``(a_rot, v, off)``.  Used for CPU tensors and as the reference the
    kernel is held against on the card."""
    return _jacobi_svd_plain(a, max_sweeps, eps=EPS, tol_eps=TOL_EPS)


def jacobi_svd_vmem_f64(a: torch.Tensor, *, max_sweeps: int = 30):
    """One-sided Jacobi on the columns of ``a`` (m×n float64, m ≥ n) in
    one launch.  Returns ``(a_rot, v, off)`` — the columns of ``a_rot``
    are uᵢ·σᵢ in no particular order (the caller sorts by σ), ``v`` the
    matching right singular vectors, ``off`` the last sweep's
    convergence measure.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors run :func:`_jacobi_svd_plain_f64`.  ``a.mT``
    should be contiguous — true for the transpose view of a row-major
    panel — or it is copied once.
    """
    global launches
    if a.dim() != 2:
        raise ValueError(f"expected a 2-D panel, got {a.dim()}-D")
    if a.dtype != torch.float64:
        raise TypeError(f"jacobi_svd_vmem_f64 takes float64, got {a.dtype}")
    m, n = a.shape
    if not supports(m, n, a.dtype):
        raise ValueError(
            f"a {m}x{n} panel is outside the kernel's reach (m >= n >= 2, "
            f"n_pad <= {_MAX_N_PAD}, {_panel_bytes(m, n)} > {_MAX_BYTES} "
            "bytes of panel and V)"
        )
    if a.device.type == "cpu":
        return _jacobi_svd_plain_f64(a, max_sweeps)
    if not a.is_cuda:
        raise ValueError(f"unsupported device {a.device}")
    lib = build()
    n_pad = n + (n % 2)
    at = a.mT.contiguous()
    a_work = torch.empty((n_pad, m), dtype=a.dtype, device=a.device)
    v_work = torch.empty((n_pad, n_pad), dtype=a.dtype, device=a.device)
    off = torch.empty((1,), dtype=a.dtype, device=a.device)
    pairs = _pair_table_on(n_pad, a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_jacobi_svd_f64(
            at.data_ptr(), a_work.data_ptr(), v_work.data_ptr(),
            off.data_ptr(), pairs.data_ptr(), m, n, int(max_sweeps), EPS,
            _tol(m, n), stream,
        )
    _build.check(lib, status, "jacobi_svd_f64 kernel launch")
    launches += 1
    # Row j of each work buffer is column j; the zero column of an odd n
    # never rotates, so dropping it loses nothing.
    return a_work[:n].mT, v_work[:n, :n].mT, off[0]
