"""K3: one-sided Jacobi SVD of a float64 panel, as a block Jacobi in one
launch.

The port of ``petal_decomposition_tpu/ops/pallas/jacobi_f64_kernel.py``
(``jacobi_svd_vmem_f64``).  A TPU has no native float64 vector
arithmetic, so the TPU kernel carries every value as a float32 (hi, lo)
pair through ``ops/pallas/df64.py``, at a unit roundoff of ≈2⁻⁴⁸, and
keeps the whole panel in VMEM.  Hopper has native float64 FMA, so
``df64.py`` is not ported; the TPU kernel's constants are.

A CTA's 227 KB of shared memory cannot hold the panels K3 serves, so the
Hopper kernel ``csrc/jacobi_svd_f64.cu`` is a block Jacobi: the columns,
padded with zero columns to n2 = 2·w·P, form 2P blocks of width w; an
outer sweep pairs the blocks by the circle method (2P − 1 outer steps);
each of P cooperative CTAs loads its block pair into shared memory, runs
one inner sweep over its 2w columns with each thread's rows in
registers, accumulates the rotations into a 2w×2w J and updates V's two
blocks as V_pq ← V_pq·J.  When the panel and V fit one CTA (P = 1) they
stay on chip for every sweep; a panel whose block pairs are too tall for
one CTA has each block pair's rows split over R CTAs.  :func:`plan` picks
(w, P, R), :func:`threads` the CTA's threads.

On a CUDA tensor the wrapper launches that kernel (one launch per call);
on a CPU tensor it runs :func:`_jacobi_svd_block_plain_f64`, the same
schedule in vectorized PyTorch.  :func:`_jacobi_svd_plain_f64`, the TPU
kernel's own order, stays as the oracle of the tests.  ``launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .jacobi_kernels import _jacobi_svd_plain, _rotation, _tol as _k2_tol

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
# in ``ops/jacobi.py`` with K3 on their R.
_MAX_N_PAD = 512
_MAX_BYTES = 4 << 20
# Dynamic shared memory one CTA may use: Hopper's 227 KB (232,448 bytes)
# less 1 KB kept for the kernel's static shared memory.
SMEM_BUDGET = 232_448 - 1024
# CTAs an H100 holds at once, one per SM: the cooperative grid's limit.
MAX_CTAS = 132
# The widest block pair the kernel is instantiated for (2w columns;
# wider ones spill registers).
MAX_W2 = 48
# A CTA has at most MAX_THREADS threads, two warps on each SM
# sub-partition, so that each may use 255 registers; a thread holds its
# rows of the block pair and one chunk of partial dot products in them
# (:func:`rows_per_thread`).  csrc/jacobi_svd_f64.cu's Cfg holds the same.
MAX_THREADS = 256
# The plan's time model, in SM cycles: an inner step costs STEP_CYCLES
# (two barriers and the rotations, formed by one warp) plus the float64
# FMAs of the busiest SM sub-partition (7 a row and column pair, two
# cycles a warp) plus SHFL_CYCLES a panel warp and chunk of eight pairs
# (the shuffle reduction); an outer step OUTER_CYCLES (grid barrier,
# block-pair copies, the certificate's reduction) plus V_pq·J.
STEP_CYCLES = 700
SHFL_CYCLES = 54
OUTER_CYCLES = 6000

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


def _even(x: int) -> int:
    return x + (x % 2)


def _warps(x: int) -> int:
    return -(-x // 32) * 32


def rows_per_thread(w2: int) -> int:
    """The most rows of a 2w = ``w2`` column block pair a thread holds:
    at most 60 doubles of rows beside 8 pairs' partial sums (where more
    spill), else 84 doubles of rows and partial sums together."""
    w = w2 // 2
    chunk = 8 if w >= 5 else (4 if w >= 3 else w)
    data = 60 if chunk == 8 else 84 - 3 * chunk
    return max(1, data // w2)


def threads(w2: int, rows: int):
    """``(rpt, ta, tj)`` for a CTA holding ``rows`` panel rows of a
    2w = ``w2`` column block pair: the most panel rows a thread may hold
    (fewer warps finish an inner step sooner: 8-15% on the served panels
    on an H100), the threads of panel rows and of J's 2w rows (one row
    each), whole warps each.  None when the CTA cannot hold them."""
    rpt = rows_per_thread(w2)
    ta, tj = _warps(-(-rows // rpt)), _warps(w2)
    return (rpt, ta, tj) if ta + tj <= MAX_THREADS else None


def smem_bytes(ld: int, w2: int, ta: int, tj: int) -> int:
    """Shared memory of a CTA of ``ta + tj`` threads: ``ld`` rows of a
    2w = ``w2`` column block pair (or of V_pq), J (w2 × w2), each warp's
    rotations and the ``ta // 32`` panel warps' partial dot products of
    two inner steps."""
    w = w2 // 2
    return 8 * (ld * w2 + w2 * w2 + w2 * (ta + tj) // 32 + 6 * w * (ta // 32))


def _fits(m_rows: int, w2: int, ld: int):
    thr = threads(w2, m_rows)
    if w2 > MAX_W2 or thr is None or smem_bytes(ld, w2, *thr[1:]) > SMEM_BUDGET:
        return None
    return thr


def sweep_cycles(m: int, w: int, p: int) -> float:
    """The plan's model of one sweep's SM cycles with block width w and
    P block pairs on an m-row panel (see ``STEP_CYCLES``)."""
    w2 = 2 * w
    rpt, ta, tj = threads(w2, _even(m))
    per_smsp = -(-(ta + tj) // 128)
    chunks = -(-w // 8)
    step = (STEP_CYCLES + 14 * rpt * w * per_smsp
            + SHFL_CYCLES * chunks * (ta // 32))
    if p == 1:
        return (w2 - 1) * step
    n2 = w2 * p
    return (2 * p - 1) * ((w2 - 1) * step + OUTER_CYCLES + n2 * w2 * w2 / 32)


@functools.lru_cache(maxsize=None)
def plan(m: int, n: int) -> tuple[int, int, int, int]:
    """``(w, P, R, mr)`` for an m×n panel within :func:`supports`: block
    width w, P block pairs (n2 = 2·w·P ≥ n columns), R row groups of mr
    rows (even, R·mr ≥ m); the grid has P·R CTAs.

    1. Of the plans whose CTA holds its block pair — in registers
       (:func:`threads`) and in shared memory (:func:`smem_bytes`, where
       the V update stages n2 rows of V_pq in the same space) — the whole
       panel in one CTA (P = 1, 2w = n_pad ≤ 64), or P ≥ 2 block pairs
       of width w = ⌈n / 2P⌉ ≤ 32: the one whose sweep
       :func:`sweep_cycles` models as shortest.  Narrow blocks spread a
       sweep over more SMs and shorten each inner step; wide ones need
       fewer outer steps and grid barriers.
    2. Else (m beyond ≈ 9k rows, where no block pair's rows fit one
       CTA) the widest blocks the kernel takes, 2w ≤ ``MAX_W2`` (P = 1
       where n_pad ≤ 48), for the fewest grid barriers a sweep, with each
       block pair's rows split over the fewest CTAs that hold them.
    """
    if not supports(m, n, torch.float64):
        raise ValueError(f"a {m}x{n} panel is outside the kernel's reach")
    n_pad = n + (n % 2)
    m_even = _even(m)
    best = None
    if _fits(m_even, n_pad, m_even):
        best = (sweep_cycles(m, n_pad // 2, 1), n_pad // 2, 1)
    for p in range(2, min(n_pad // 2, MAX_CTAS) + 1):
        w = -(-n // (2 * p))
        if not _fits(m_even, 2 * w, max(m_even, 2 * w * p)):
            continue
        cycles = sweep_cycles(m, w, p)
        if best is None or cycles < best[0]:
            best = (cycles, w, p)
    if best is not None:
        return best[1], best[2], 1, m_even
    for p in range(1, n_pad // 2 + 1):
        w = n_pad // 2 if p == 1 else -(-n // (2 * p))
        if 2 * w > MAX_W2:
            continue
        for r in range(2, MAX_CTAS // p + 1):
            mr = _even(-(-m // r))
            if _fits(mr, 2 * w, mr if p == 1 else max(mr, 2 * w * p)):
                return w, p, r, mr
    raise ValueError(f"no block plan fits a {m}x{n} panel")


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
    """The kernel's block schedule in vectorized PyTorch: ``(a_rot, v,
    off)``.  Blocks of ``w`` columns (zero columns pad n to 2·w·P), the
    circle method over the 2P blocks, one inner sweep of the same
    rotation over each block pair's 2w columns with the rotations
    accumulated into J, then V_pq ← V_pq·J.  ``off`` of a sweep is the
    maximum over its outer steps of (largest |apq| of the step's pair
    visits) / (largest app or aqq of the step); sweeps stop once it is
    at most ``_tol``.  Used for CPU tensors and as the reference the
    kernel is held against on the card."""
    from ..jacobi import round_robin_pairings

    m, n = a.shape
    p_count = -(-n // (2 * w))
    n2 = 2 * w * p_count
    dt, dev = a.dtype, a.device
    tol = _tol(m, n)
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
                c, sn = _rotation(app, aqq, apq, EPS)
                c, sn = c[..., None], sn[..., None]
                s[:, p], s[:, q] = c * xl - sn * xr, sn * xl + c * xr
                jl, jr = jt[:, p], jt[:, q]
                jt[:, p], jt[:, q] = c * jl - sn * jr, sn * jl + c * jr
            off_t = torch.maximum(
                off_t, apq_max / torch.where(nrm_max > 0, nrm_max, 1.0)
            )
            at[cols] = s
            vt[cols] = jt @ vt[cols]
        off = float(off_t)
    return at[:n].mT, vt[:n, :n].mT, torch.tensor(off, dtype=dt, device=dev)


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
    lib = build()
    n2 = 2 * w * p_count
    thr = threads(2 * w, mr)
    if thr is None:
        raise ValueError(f"block plan {(w, p_count, r_count, mr)} does not "
                         "fit a CTA")
    rpt, ta, tj = thr
    at = a.mT.contiguous()
    a_work = torch.empty((n2, r_count * mr), dtype=a.dtype, device=a.device)
    v_work = torch.empty((n2, n2), dtype=a.dtype, device=a.device)
    off = torch.empty((1,), dtype=a.dtype, device=a.device)
    scratch = torch.empty(
        (6 * w * p_count * r_count
         + 4 * (2 * p_count - 1) * p_count * r_count,),
        dtype=a.dtype,
        device=a.device,
    )
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.petal_jacobi_svd_f64(
            at.data_ptr(), a_work.data_ptr(), v_work.data_ptr(),
            off.data_ptr(), scratch.data_ptr(), m, n, w, p_count, r_count,
            mr, rpt, ta, tj, int(max_sweeps), EPS, _tol(m, n), stream,
        )
    _build.check(lib, status, "jacobi_svd_f64 kernel launch")
    launches += 1
    # Row j of each work buffer is column j; the zero padding columns
    # never rotate, so dropping them loses nothing.
    return a_work[:n, :m].mT, v_work[:n, :n].mT, off[0]
