"""K2: one-sided Jacobi SVD of a float32 panel in one launch.

The port of ``petal_decomposition_tpu/ops/pallas/jacobi_kernels.py``
(``jacobi_svd_vmem``).  On a CUDA tensor the wrapper launches the
hand-written Hopper kernel ``csrc/jacobi_svd.cu`` (one block, the whole
panel in shared memory, every step and sweep in the launch); on a CPU
tensor it runs :func:`_jacobi_svd_plain`, a vectorized PyTorch
transcription of the TPU kernel with the same pairing, skip rule and
convergence measure.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["jacobi_svd_vmem", "supports", "build", "launches"]

# Shared memory one block may use on Hopper (227 KB), less a margin for
# the kernel's static shared variables.
_SMEM_LIMIT = 232_448 - 1024

launches = 0


def _smem_bytes(m: int, n: int) -> int:
    n_pad = n + (n % 2)
    return 4 * (n_pad * m + n_pad * n_pad + 2 * n_pad)


def supports(m: int, n: int, dtype) -> bool:
    """True when the kernel takes an m×n panel (m ≥ n, the caller's
    orientation): float32, n ≥ 2, and the padded panel plus V fitting
    one block's shared memory.  The flagship panel (Bᵀ, 1024×43 → 44
    columns) needs 188 KB."""
    if dtype != torch.float32 or n < 2 or m < n:
        return False
    return _smem_bytes(m, n) <= _SMEM_LIMIT


@functools.lru_cache(maxsize=None)
def _tournament_perm(n: int) -> np.ndarray:
    """The circle-method step permutation of the TPU kernel's
    left/right-half layout (``_tournament_perms`` there): positions
    [L0..Lh-1, R0..Rh-1], pair i = (Li, Ri); L0 stays, every other
    position moves one place.  ``perm[j]`` is the OLD position that
    lands at position j."""
    h = n // 2
    perm = np.empty(n, dtype=np.int64)
    perm[0] = 0
    if h > 1:
        perm[1] = h  # L1 <- R0
        for i in range(2, h):
            perm[i] = i - 1
    for i in range(h - 1):
        perm[h + i] = h + i + 1
    perm[n - 1] = h - 1
    return perm


@functools.lru_cache(maxsize=None)
def pair_table(n_pad: int) -> np.ndarray:
    """(n_pad-1, n_pad) int32: at step s, column ``t[s, i]`` pairs with
    column ``t[s, h + i]``.  The TPU kernel moves columns through the
    positions; here the columns stay put and the table follows them,
    so row s is the column found at each position after s advances.
    The step permutation is one (n_pad-1)-cycle, so every sweep starts
    from the identity again."""
    perm = _tournament_perm(n_pad)
    pos = np.arange(n_pad, dtype=np.int64)
    rows = []
    for _ in range(n_pad - 1):
        rows.append(pos.copy())
        pos = pos[perm]
    return np.asarray(rows, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _pair_table_on(n_pad: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(pair_table(n_pad)).to(device)


# float32's unit roundoff: the TPU kernel's skip and stop constant.
EPS = float(np.finfo(np.float32).eps)


def _tol(m: int, n: int, tol_eps: float = EPS) -> float:
    """The stop rule's threshold, ``tol_eps·√max(m, n_pad)``."""
    n_pad = n + (n % 2)
    return tol_eps * float(np.sqrt(max(m, n_pad)))


def build() -> ctypes.CDLL:
    """Compile (at first use) and load the kernel library."""
    lib = _build.load_library("petal_jacobi_svd", ("jacobi_svd.cu",))
    fn = lib.petal_jacobi_svd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return lib


def _rotation(app, aqq, apq, eps: float):
    """The kernels' rotation ``(c, s)`` of each column pair from its
    dot products: the identity where |apq| ≤ ``eps``·√(app·aqq) (which
    also covers zero columns), else the Jacobi rotation that zeroes
    apq."""
    skip = apq.abs() <= eps * torch.sqrt(app * aqq)
    sgn = torch.where(apq >= 0, 1.0, -1.0).to(apq.dtype)
    absq = torch.where(skip, 1.0, apq.abs())
    tau = (aqq - app) / (2.0 * absq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)
    t = torch.where(skip, 0.0, t * sgn)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t


def _jacobi_svd_plain(a: torch.Tensor, max_sweeps: int, eps: float = EPS,
                      tol_eps: float = EPS):
    """The TPU kernel's arithmetic in vectorized PyTorch: ``(a_rot, v,
    off)`` with the same pair schedule, rotation, skip rule
    (|apq| ≤ ``eps``·√(app·aqq)) and per-sweep norm-wise ``off``,
    stopping at ``_tol(m, n, tol_eps)``.  Works at ``a``'s dtype; K3
    runs it at float64 with its own constants.  Used for CPU tensors
    and as the reference the kernels are held against on the card."""
    m, n = a.shape
    n_pad = n + (n % 2)
    h = n_pad // 2
    dt, dev = a.dtype, a.device
    tol = _tol(m, n, tol_eps)
    # Columns as rows, so a pair's columns are contiguous row gathers.
    at = torch.zeros((n_pad, m), dtype=dt, device=dev)
    at[:n] = a.mT
    vt = torch.eye(n_pad, dtype=dt, device=dev)
    table = _pair_table_on(n_pad, dev).long()
    off = float("inf")
    for _ in range(max_sweeps):
        if off <= tol:
            break
        off_t = torch.zeros((), dtype=dt, device=dev)
        for step in range(n_pad - 1):
            p, q = table[step, :h], table[step, h:]
            xl, xr = at[p], at[q]
            app = (xl * xl).sum(1)
            aqq = (xr * xr).sum(1)
            apq = (xl * xr).sum(1)
            norm2max = torch.maximum(app.max(), aqq.max())
            rel = apq.abs() / torch.where(norm2max > 0, norm2max, 1.0)
            off_t = torch.maximum(off_t, rel.max())
            c, s = _rotation(app, aqq, apq, eps)
            c, s = c[:, None], s[:, None]
            at[p], at[q] = c * xl - s * xr, s * xl + c * xr
            vl, vr = vt[p], vt[q]
            vt[p], vt[q] = c * vl - s * vr, s * vl + c * vr
        off = float(off_t)
    return at[:n].mT, vt[:n, :n].mT, torch.tensor(off, dtype=dt, device=dev)


def jacobi_svd_vmem(a: torch.Tensor, *, max_sweeps: int = 30):
    """One-sided Jacobi on the columns of ``a`` (m×n float32, m ≥ n)
    in one launch.  Returns ``(a_rot, v, off)`` — the columns of
    ``a_rot`` are uᵢ·σᵢ in no particular order (the caller sorts by σ),
    ``v`` the matching right singular vectors, ``off`` the last sweep's
    convergence measure.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched); CPU tensors run :func:`_jacobi_svd_plain`.  ``a.mT``
    should be contiguous — true for the transpose view of a row-major
    panel — or it is copied once.
    """
    global launches
    if a.dim() != 2:
        raise ValueError(f"expected a 2-D panel, got {a.dim()}-D")
    if a.dtype != torch.float32:
        raise TypeError(f"jacobi_svd_vmem takes float32, got {a.dtype}")
    m, n = a.shape
    if not supports(m, n, a.dtype):
        raise ValueError(
            f"a {m}x{n} panel is outside the kernel's reach "
            f"({_smem_bytes(m, n)} bytes of shared memory, m >= n >= 2)"
        )
    if a.device.type == "cpu":
        return _jacobi_svd_plain(a, max_sweeps)
    if not a.is_cuda:
        raise ValueError(f"unsupported device {a.device}")
    lib = build()
    at = a.mT.contiguous()
    arot_t = torch.empty((n, m), dtype=a.dtype, device=a.device)
    v_t = torch.empty((n, n), dtype=a.dtype, device=a.device)
    off = torch.empty((1,), dtype=a.dtype, device=a.device)
    pairs = _pair_table_on(n + (n % 2), a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_jacobi_svd_f32(
            at.data_ptr(), arot_t.data_ptr(), v_t.data_ptr(), off.data_ptr(),
            pairs.data_ptr(), m, n, int(max_sweeps), _tol(m, n), stream,
        )
    _build.check(lib, status, "jacobi_svd kernel launch")
    launches += 1
    return arot_t.mT, v_t.mT, off[0]
