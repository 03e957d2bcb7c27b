"""K3: one-sided Jacobi SVD of a float64 panel, as a block Jacobi in one
launch.

The port of ``petal_decomposition_tpu/ops/pallas/jacobi_f64_kernel.py``
(``jacobi_svd_vmem_f64``).  A TPU has no native float64 vector
arithmetic, so the TPU kernel carries every value as a float32 (hi, lo)
pair through ``ops/pallas/df64.py``, at a unit roundoff of ≈2⁻⁴⁸, and
keeps the whole panel in VMEM.  Hopper has native float64 FMA, so
``df64.py`` is not ported; the TPU kernel's constants are.

A CTA's 227 KB of shared memory cannot hold the panels K3 serves, so the
Hopper kernel ``csrc/jacobi_svd_f64.cu`` is the float64 instance of the
block Jacobi in ``csrc/jacobi_block.cuh``, which K2 shares (see
``jacobi_block.py``): blocks of w columns paired by the circle method,
one cooperative CTA per block pair with its rows in registers, the
whole panel on chip when it fits one CTA, and each block pair's rows
split over R CTAs when they do not.  :func:`plan` picks (w, P, R),
:func:`threads` the CTA's threads.

On a CUDA tensor the wrapper launches that kernel (one launch per call);
on a CPU tensor it runs :func:`_jacobi_svd_block_plain_f64`, the same
schedule in vectorized PyTorch.  :func:`_jacobi_svd_plain_f64`, the TPU
kernel's own order, stays as the oracle of the tests.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ...utils import debugging
from . import _build, jacobi_block
from .jacobi_block import MAX_CTAS, MAX_THREADS, MAX_W2, SMEM_BUDGET, _warps
from .jacobi_kernels import (
    _jacobi_svd_block_plain,
    _jacobi_svd_plain,
    _tol as _k2_tol,
)

__all__ = ["jacobi_svd_vmem_f64", "supports", "plan", "build", "launches"]

# The TPU kernel's constants (jacobi_f64_kernel.py:34-35), shared by the
# kernel and its plain versions.  The skip rule uses 2⁻⁴⁸, the TPU
# kernel's working precision, rather than float64's 2⁻⁵²: the extra
# rotations that 2⁻⁵² would apply sit below the stop rule's 2⁻⁴⁶ and
# change no certified digit.  The stop rule, 2⁻⁴⁶·√max(m, n_pad), stays
# under the certificate's 2⁻⁴⁵·√dim (``linalg.convergence_tol``).
EPS = 2.0 ** -48
TOL_EPS = 2.0 ** -46

# The kernel's reach.  n_pad ≤ 512 and (m + n_pad)·n_pad·8 ≤ 4 MiB of
# panel and V (1000×64 needs 545 KB, the 1024×42 Bᵀ 358 KB, a 256×256
# matrix 1 MiB, 512×512 exactly 4 MiB); taller panels take the QR route
# in ``ops/jacobi.py`` with K3 on their R.  The plan's time model, in SM
# cycles (``jacobi_block.CycleModel``): a float64 FMA takes a warp two
# cycles of its SM sub-partition, and a shuffle of a double two 32-bit
# shuffles.
_MAX_N_PAD = 512
_MAX_BYTES = 4 << 20
_PLAN = jacobi_block.BlockPlan(
    torch.float64, _MAX_N_PAD, _MAX_BYTES,
    jacobi_block.CycleModel(step=700, fma=14, shfl=54, outer=6000, v_rate=32),
)
supports = _PLAN.supports
rows_per_thread = _PLAN.rows_per_thread
threads = _PLAN.threads
smem_bytes = _PLAN.smem_bytes
sweep_cycles = _PLAN.sweep_cycles
plan = _PLAN.plan
_fits = _PLAN.fits
_panel_bytes = _PLAN.panel_bytes

launches = 0


def _tol(m: int, n: int) -> float:
    return _k2_tol(m, n, TOL_EPS)


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_jacobi_svd_f64", ("jacobi_svd_f64.cu",))
    fn = lib.petal_jacobi_svd_f64
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_double, ctypes.c_double, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _jacobi_svd_plain_f64(a: torch.Tensor, max_sweeps: int):
    """The TPU kernel's order and arithmetic in vectorized PyTorch at
    float64: ``(a_rot, v, off)``.  The tests' oracle for the TPU kernel's
    schedule."""
    return _jacobi_svd_plain(a, max_sweeps, eps=EPS, tol_eps=TOL_EPS)


def _jacobi_svd_block_plain_f64(a: torch.Tensor, max_sweeps: int, w: int):
    """The kernel's block schedule in vectorized PyTorch at float64
    (:func:`jacobi_kernels._jacobi_svd_block_plain` with K3's
    constants): ``(a_rot, v, off)``.  Used for CPU tensors and as the
    reference the kernel is held against on the card."""
    return _jacobi_svd_block_plain(a, max_sweeps, w, eps=EPS, tol_eps=TOL_EPS)


def jacobi_svd_vmem_f64(a: torch.Tensor, *, max_sweeps: int = 30):
    """One-sided Jacobi on the columns of ``a`` (m×n float64, m ≥ n) in
    one launch.  Returns ``(a_rot, v, off)`` — the columns of ``a_rot``
    are uᵢ·σᵢ in no particular order (the caller sorts by σ), ``v`` the
    matching right singular vectors, ``off`` the last sweep's
    convergence measure.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched, or if its grid cannot be co-resident); CPU tensors run
    :func:`_jacobi_svd_block_plain_f64` with the kernel's block width.
    ``a.mT`` should be contiguous — true for the transpose view of a
    row-major panel — or it is copied once.
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
    w, p_count, r_count, mr = plan(m, n)
    if a.device.type == "cpu":
        return _jacobi_svd_block_plain_f64(a, max_sweeps, w)
    if not a.is_cuda:
        raise ValueError(f"unsupported device {a.device}")
    thr = threads(2 * w, mr)
    if thr is None:
        raise ValueError(f"block plan {(w, p_count, r_count, mr)} does not "
                         "fit a CTA")
    lib = build()
    out = jacobi_block.launch(lib, lib.petal_jacobi_svd_f64, a, max_sweeps,
                              (w, p_count, r_count, mr), thr, EPS,
                              _tol(m, n))
    launches += 1
    debugging.check_kernel_outputs("jacobi_svd_vmem_f64 (K3)", *out)
    return out
