"""The block plan and the launch of the block one-sided Jacobi kernel
``csrc/jacobi_block.cuh``, shared by K2 (float32, ``jacobi_kernels.py``)
and K3 (float64, ``jacobi_f64_kernel.py``).

The kernel pads the n columns with zero columns to n2 = 2·w·P and forms
2P blocks of width w; an outer sweep pairs the blocks by the circle
method (2P − 1 outer steps); each of P cooperative CTAs loads its block
pair into shared memory, runs one inner sweep over its 2w columns with
each thread's rows in registers, accumulates the rotations into a 2w×2w
J and updates V's two blocks as V_pq ← V_pq·J.  When the panel and V
fit one CTA (P = 1) they stay on chip for every sweep; a panel whose
block pairs are too tall for one CTA has each block pair's rows split
over R CTAs.  :class:`BlockPlan` holds one element type's reach and
picks (w, P, R, mr) and the CTA's threads; :func:`launch` runs the
kernel on a CUDA panel.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from . import _build

__all__ = ["BlockPlan", "CycleModel", "launch"]

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
# rows of the block pair and one chunk of partial dot products in
# REG_WORDS of them, its rows in at most ROW_WORDS where the chunk is of
# eight pairs or the element a float (where more spill).
# csrc/jacobi_block.cuh's Cfg holds the same.
MAX_THREADS = 256
REG_WORDS = 168
ROW_WORDS = 120


def _even(x: int) -> int:
    return x + (x % 2)


def _warps(x: int) -> int:
    return -(-x // 32) * 32


@dataclasses.dataclass(frozen=True)
class CycleModel:
    """A plan's model of an inner step, in SM cycles: ``step`` (two
    barriers and the rotations, formed by one warp) plus ``fma`` a row
    and column pair for the FMAs of the busiest SM sub-partition (7 a
    pair, times a warp's issue cycles) plus ``shfl`` a panel warp and
    chunk of eight pairs (the shuffle reduction); an outer step costs
    ``outer`` (grid barrier, block-pair copies, the certificate's
    reduction) plus V_pq·J at ``v_rate`` FMAs a cycle."""

    step: float
    fma: float
    shfl: float
    outer: float
    v_rate: float


class BlockPlan:
    """The kernel's reach and block plan for one element type: panels
    with n_pad = n + (n odd) ≤ ``max_n_pad`` and (m + n_pad)·n_pad
    elements of panel and V within ``max_bytes``."""

    def __init__(self, dtype: torch.dtype, max_n_pad: int, max_bytes: int,
                 cycles: CycleModel):
        self.dtype = dtype
        self.size = torch.finfo(dtype).bits // 8
        self.words = self.size // 4  # 32-bit registers an element takes
        self.max_n_pad = max_n_pad
        self.max_bytes = max_bytes
        self.cycles = cycles
        self.plan = functools.lru_cache(maxsize=None)(self._plan)

    def panel_bytes(self, m: int, n: int) -> int:
        n_pad = n + (n % 2)
        return self.size * (m + n_pad) * n_pad

    def supports(self, m: int, n: int, dtype) -> bool:
        """True when the kernel takes an m×n panel (m ≥ n, the caller's
        orientation): this element type, n ≥ 2, n_pad ≤ ``max_n_pad``
        and (m + n_pad)·n_pad elements within ``max_bytes``."""
        if dtype != self.dtype or n < 2 or m < n:
            return False
        return (n + (n % 2) <= self.max_n_pad
                and self.panel_bytes(m, n) <= self.max_bytes)

    def rows_per_thread(self, w2: int) -> int:
        """The most rows of a 2w = ``w2`` column block pair a thread
        holds: at most ROW_WORDS registers of rows beside 8 pairs'
        partial sums or in float32, else REG_WORDS of rows and partial
        sums together."""
        w = w2 // 2
        chunk = 8 if w >= 5 else (4 if w >= 3 else w)
        data = (ROW_WORDS // self.words if chunk == 8 or self.words == 1
                else REG_WORDS // self.words - 3 * chunk)
        return max(1, data // w2)

    def threads(self, w2: int, rows: int):
        """``(rpt, ta, tj)`` for a CTA holding ``rows`` panel rows of a
        2w = ``w2`` column block pair: the most panel rows a thread may
        hold (fewer warps finish an inner step sooner: 8-15% on K3's
        panels on an H100), the threads of panel rows and of J's 2w rows
        (one row each), whole warps each.  None when the CTA cannot hold
        them."""
        rpt = self.rows_per_thread(w2)
        ta, tj = _warps(-(-rows // rpt)), _warps(w2)
        return (rpt, ta, tj) if ta + tj <= MAX_THREADS else None

    def smem_bytes(self, ld: int, w2: int, ta: int, tj: int) -> int:
        """Shared memory of a CTA of ``ta + tj`` threads: ``ld`` rows of a
        2w = ``w2`` column block pair (or of V_pq), J (w2 × w2), each
        warp's rotations and the ``ta // 32`` panel warps' partial dot
        products of two inner steps."""
        w = w2 // 2
        return self.size * (ld * w2 + w2 * w2 + w2 * (ta + tj) // 32
                            + 6 * w * (ta // 32))

    def fits(self, m_rows: int, w2: int, ld: int):
        thr = self.threads(w2, m_rows)
        if (w2 > MAX_W2 or thr is None
                or self.smem_bytes(ld, w2, *thr[1:]) > SMEM_BUDGET):
            return None
        return thr

    def sweep_cycles(self, m: int, w: int, p: int) -> float:
        """The plan's model of one sweep's SM cycles with block width w
        and P block pairs on an m-row panel (:class:`CycleModel`)."""
        cm = self.cycles
        w2 = 2 * w
        rpt, ta, tj = self.threads(w2, _even(m))
        per_smsp = -(-(ta + tj) // 128)
        chunks = -(-w // 8)
        step = (cm.step + cm.fma * rpt * w * per_smsp
                + cm.shfl * chunks * (ta // 32))
        if p == 1:
            return (w2 - 1) * step
        n2 = w2 * p
        return (2 * p - 1) * ((w2 - 1) * step + cm.outer
                              + n2 * w2 * w2 / cm.v_rate)

    def _plan(self, m: int, n: int) -> tuple[int, int, int, int]:
        """``(w, P, R, mr)`` for an m×n panel within :meth:`supports`:
        block width w, P block pairs (n2 = 2·w·P ≥ n columns), R row
        groups of mr rows (even, R·mr ≥ m); the grid has P·R CTAs.

        1. Of the plans whose CTA holds its block pair — in registers
           (:meth:`threads`) and in shared memory (:meth:`smem_bytes`,
           where the V update stages n2 rows of V_pq in the same space)
           — the whole panel in one CTA (P = 1, 2w = n_pad ≤ 48), or
           P ≥ 2 block pairs of width w = ⌈n / 2P⌉: the one whose sweep
           :meth:`sweep_cycles` models as shortest.  Narrow blocks spread
           a sweep over more SMs and shorten each inner step; wide ones
           need fewer outer steps and grid barriers.
        2. Else (where no block pair's rows fit one CTA) the widest
           blocks the kernel takes, 2w ≤ ``MAX_W2`` (P = 1 where
           n_pad ≤ 48), for the fewest grid barriers a sweep, with each
           block pair's rows split over the fewest CTAs that hold them.
        """
        if not self.supports(m, n, self.dtype):
            raise ValueError(f"a {m}x{n} panel is outside the kernel's reach")
        n_pad = n + (n % 2)
        m_even = _even(m)
        best = None
        if self.fits(m_even, n_pad, m_even):
            best = (self.sweep_cycles(m, n_pad // 2, 1), n_pad // 2, 1)
        for p in range(2, min(n_pad // 2, MAX_CTAS) + 1):
            w = -(-n // (2 * p))
            if not self.fits(m_even, 2 * w, max(m_even, 2 * w * p)):
                continue
            cycles = self.sweep_cycles(m, w, p)
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
                if self.fits(mr, 2 * w, mr if p == 1 else max(mr, 2 * w * p)):
                    return w, p, r, mr
        raise ValueError(f"no block plan fits a {m}x{n} panel")


def launch(lib, fn, a: torch.Tensor, max_sweeps: int, block_plan,
           thr, eps: float, tol: float):
    """Run the C entry point ``fn`` of ``lib`` (``launch_block_jacobi``
    for ``a``'s element type) on the CUDA panel ``a`` (m×n, m ≥ n) under
    ``block_plan`` = (w, P, R, mr) with the CTA shape ``thr`` = (rpt, ta,
    tj): ``(a_rot, v, off)``.  Raises if the launch is refused."""
    m, n = a.shape
    w, p_count, r_count, mr = block_plan
    rpt, ta, tj = thr
    n2 = 2 * w * p_count
    kw = {"dtype": a.dtype, "device": a.device}
    at = a.mT.contiguous()
    a_work = torch.empty((n2, r_count * mr), **kw)
    v_work = torch.empty((n2, n2), **kw)
    off = torch.empty((1,), **kw)
    scratch = torch.empty(
        (6 * w * p_count * r_count
         + 4 * (2 * p_count - 1) * p_count * r_count,), **kw)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = fn(
            at.data_ptr(), a_work.data_ptr(), v_work.data_ptr(),
            off.data_ptr(), scratch.data_ptr(), m, n, w, p_count, r_count,
            mr, rpt, ta, tj, int(max_sweeps), eps, tol, stream,
        )
    _build.check(lib, status, f"{fn.__name__} kernel launch")
    # Row j of each work buffer is column j; the zero padding columns
    # never rotate, so dropping them loses nothing.
    return a_work[:n, :m].mT, v_work[:n, :n].mT, off[0]
