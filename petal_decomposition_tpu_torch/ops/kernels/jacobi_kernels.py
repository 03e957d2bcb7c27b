"""K2: one-sided Jacobi SVD of a float32 panel, as a block Jacobi in one
launch.

The port of ``petal_decomposition_tpu/ops/pallas/jacobi_kernels.py``
(``jacobi_svd_vmem``), which keeps the whole panel in VMEM.  A CTA's
227 KB of shared memory cannot hold most of the panels K2 serves, so
the Hopper kernel ``csrc/jacobi_svd.cu`` is the float32 instance of the
block Jacobi in ``csrc/jacobi_block.cuh``, which K3 shares (see
``jacobi_block.py``): blocks of w columns paired by the circle method,
one cooperative CTA per block pair with its rows in registers and the
whole panel on chip when it fits one CTA.  :func:`plan` picks (w, P, R),
:func:`threads` the CTA's threads; within K2's reach every plan has
R = 1 (the row split serves K3's taller panels).

On a CUDA tensor the wrapper launches that kernel (one launch per call);
on a CPU tensor it runs :func:`_jacobi_svd_block_plain`, the same
schedule in vectorized PyTorch.  :func:`_jacobi_svd_plain`, a
transcription of the TPU kernel's own order, stays as the oracle of the
tests.  Both plain versions take K3's constants too.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils import debugging
from . import _build, jacobi_block
from .jacobi_block import MAX_CTAS, MAX_THREADS, MAX_W2, SMEM_BUDGET, _warps

__all__ = ["jacobi_svd_vmem", "supports", "plan", "build", "launches"]

# The kernel's reach is the JAX kernel's gate
# (``ops/pallas/jacobi_kernels.py:157-170``): m·max(n_pad, 128) ≤ 400,000
# (a square R up to 632×632, 3125×128, 1024×110).  Its 10 MiB working
# set, n_pad ≤ 632 and 4 MiB of panel and V (632×632 needs 3.2 MB, the
# 1024×43 Bᵀ 0.2 MB) follow from that.  Taller panels take the QR route
# in ``ops/jacobi.py`` with K2 on their R, as in the JAX package; past
# the gate that route measured faster than K2 on the panel itself
# (``chip_smoke.py`` phase ``k2_reach``).  The plan's time model, in SM
# cycles (``jacobi_block.CycleModel``): a float32 FMA takes a warp one
# cycle of its SM sub-partition.
_MAX_N_PAD = 632
_MAX_BYTES = 4 << 20
_MAX_PADDED = 400_000
_CYCLES = jacobi_block.CycleModel(step=700, fma=7, shfl=27, outer=6000,
                                  v_rate=64)
_PLAN = jacobi_block.BlockPlan(torch.float32, _MAX_N_PAD, _MAX_BYTES,
                               _CYCLES, _MAX_PADDED)
supports = _PLAN.supports
rows_per_thread = _PLAN.rows_per_thread
threads = _PLAN.threads
smem_bytes = _PLAN.smem_bytes
sweep_cycles = _PLAN.sweep_cycles
plan = _PLAN.plan
_fits = _PLAN.fits
_panel_bytes = _PLAN.panel_bytes

launches = 0


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
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
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


def _rotate(x, y, c, s):
    """The kernel's update of a column pair, (c·x − s·y, s·x + c·y).  In
    float32 (K2) c is held as 1 + (c − 1), c − 1 = −s²/(1 + c), and the
    two small terms are summed before x is added: c of a small rotation
    rounds to 1, and c = 1 beside s = t would grow the pair's norm by
    1 + t² each time, a drift that the thousands of small rotations of
    the late sweeps add up (``csrc/jacobi_block.cuh``, ``rotate``)."""
    if x.dtype == torch.float32:
        cm1 = -(s * s) / (1.0 + c)
        return x + (cm1 * x - s * y), y + (cm1 * y + s * x)
    return c * x - s * y, s * x + c * y


def _jacobi_svd_plain(a: torch.Tensor, max_sweeps: int, eps: float = EPS,
                      tol_eps: float = EPS):
    """The TPU kernel's arithmetic in vectorized PyTorch: ``(a_rot, v,
    off)`` with the same pair schedule, rotation, skip rule
    (|apq| ≤ ``eps``·√(app·aqq)) and per-sweep norm-wise ``off``,
    stopping at ``_tol(m, n, tol_eps)``.  Works at ``a``'s dtype; K3
    runs it at float64 with its own constants.  The tests' oracle for
    the TPU kernel's schedule."""
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


def _jacobi_svd_block_plain(a: torch.Tensor, max_sweeps: int, w: int,
                            eps: float = EPS, tol_eps: float = EPS):
    """The kernel's block schedule in vectorized PyTorch at ``a``'s
    dtype: ``(a_rot, v, off)``.  Blocks of ``w`` columns (zero columns
    pad n to 2·w·P), the circle method over the 2P blocks, one inner
    sweep of the same rotation (applied as :func:`_rotate` applies it)
    over each block pair's 2w columns with the rotations accumulated
    into J, then V_pq ← V_pq·J.  ``off`` of a
    sweep is the maximum over its outer steps of (largest |apq| of the
    step's pair visits) / (largest app or aqq of the step); sweeps stop
    once it is at most ``_tol(m, n, tol_eps)``.  Used for CPU tensors and
    as the reference the kernel is held against on the card; K3 runs it
    at float64 with its own constants."""
    from ..jacobi import round_robin_pairings

    m, n = a.shape
    p_count = -(-n // (2 * w))
    n2 = 2 * w * p_count
    dt, dev = a.dtype, a.device
    tol = _tol(m, n, tol_eps)
    # Columns as rows, so a block's columns are contiguous row gathers.
    at = torch.zeros((n2, m), dtype=dt, device=dev)
    at[:n] = a.mT
    vt = torch.eye(n2, dtype=dt, device=dev)
    outer = torch.from_numpy(round_robin_pairings(2 * p_count)).to(dev)
    inner = torch.from_numpy(round_robin_pairings(2 * w)).to(dev)
    blk = torch.arange(w, device=dev)
    eye = torch.eye(2 * w, dtype=dt, device=dev)
    off = float("inf")
    for _ in range(max_sweeps):
        if off <= tol:
            break
        off_t = torch.zeros((), dtype=dt, device=dev)
        for step in outer:
            # (P, 2w) global columns of each block pair.
            cols = torch.cat([step[:, :1] * w + blk, step[:, 1:] * w + blk], 1)
            s = at[cols]
            jt = eye.expand(p_count, -1, -1).clone()  # rows: columns of J
            apq_max = torch.zeros((), dtype=dt, device=dev)
            nrm_max = torch.zeros((), dtype=dt, device=dev)
            for pq in inner:
                p, q = pq[:, 0], pq[:, 1]
                xl, xr = s[:, p], s[:, q]
                app = (xl * xl).sum(-1)
                aqq = (xr * xr).sum(-1)
                apq = (xl * xr).sum(-1)
                nrm_max = torch.maximum(
                    nrm_max, torch.maximum(app.max(), aqq.max())
                )
                apq_max = torch.maximum(apq_max, apq.abs().max())
                c, sn = _rotation(app, aqq, apq, eps)
                c, sn = c[..., None], sn[..., None]
                s[:, p], s[:, q] = _rotate(xl, xr, c, sn)
                jt[:, p], jt[:, q] = _rotate(jt[:, p], jt[:, q], c, sn)
            off_t = torch.maximum(
                off_t, apq_max / torch.where(nrm_max > 0, nrm_max, 1.0)
            )
            at[cols] = s
            vt[cols] = jt @ vt[cols]
        off = float(off_t)
    return at[:n].mT, vt[:n, :n].mT, torch.tensor(off, dtype=dt, device=dev)


def jacobi_svd_vmem(a: torch.Tensor, *, max_sweeps: int = 30):
    """One-sided Jacobi on the columns of ``a`` (m×n float32, m ≥ n)
    in one launch.  Returns ``(a_rot, v, off)`` — the columns of
    ``a_rot`` are uᵢ·σᵢ in no particular order (the caller sorts by σ),
    ``v`` the matching right singular vectors, ``off`` the last sweep's
    convergence measure.

    CUDA tensors launch the kernel (and raise if it cannot be built or
    launched, or if its grid cannot be co-resident); CPU tensors run
    :func:`_jacobi_svd_block_plain` with the kernel's block width.
    ``a.mT`` should be contiguous — true for the transpose view of a
    row-major panel — or it is copied once.
    """
    global launches
    if a.dim() != 2:
        raise ValueError(f"expected a 2-D panel, got {a.dim()}-D")
    if a.dtype != torch.float32:
        raise TypeError(f"jacobi_svd_vmem takes float32, got {a.dtype}")
    m, n = a.shape
    if not supports(m, n, a.dtype):
        raise ValueError(
            f"a {m}x{n} panel is outside the kernel's reach (m >= n >= 2, "
            f"m * max(n_pad, 128) <= {_MAX_PADDED})"
        )
    w, p_count, r_count, mr = plan(m, n)
    if a.device.type == "cpu":
        return _jacobi_svd_block_plain(a, max_sweeps, w)
    if not a.is_cuda:
        raise ValueError(f"unsupported device {a.device}")
    thr = threads(2 * w, mr)
    if thr is None:
        raise ValueError(f"block plan {(w, p_count, r_count, mr)} does not "
                         "fit a CTA")
    lib = build()
    out = jacobi_block.launch(lib, lib.petal_jacobi_svd_f32, a, max_sweeps,
                              (w, p_count, r_count, mr), thr, EPS,
                              _tol(m, n))
    launches += 1
    debugging.check_kernel_outputs("jacobi_svd_vmem (K2)", *out)
    return out
