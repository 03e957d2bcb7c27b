"""Centering-fused contractions — the counterpart of
``petal_decomposition_tpu/ops/centered.py``.

The mean is a rank-1 correction that fuses into each matmul:

    (X − 1μᵀ)·Ω   = X·Ω − 1·(μᵀΩ)
    (X − 1μᵀ)ᴴ·Q  = XᴴQ − μ̄·(1ᵀQ)
    ‖X − 1μᵀ‖²_F  = ‖X‖²_F − n·‖μ‖²

so the data matrix is read once per contraction and never copied.
Complex data takes the conjugate transposes and squared moduli; for
real data they are the plain transposes and squares.  (The
centered Gram ``XᵀX − n·μμᵀ`` is formed, with its own guard, in
``parallel/distributed.py``.)

``valid`` handles zero-padded rows (a mesh shard past the data): the
broadcast term of a product X·M puts ``−μᵀM`` on padded rows, which
must be re-zeroed; the other contractions either sum over rows (zero
rows add nothing) or take a ``Q`` that is already zero there.
"""

from __future__ import annotations

import torch

from .linalg import mdot

__all__ = [
    "mask_rows",
    "centered_matmul",
    "centered_rmatmul",
    "centered_sqnorm_guarded",
    "guarded_sqnorm_from",
    "abs2",
]


def mask_rows(y, valid: int | None):
    """``y`` with its rows from ``valid`` on set to zero (``y`` itself
    when every row is valid).

    >>> mask_rows(torch.ones(3, 2), 2).tolist()
    [[1.0, 1.0], [1.0, 1.0], [0.0, 0.0]]
    """
    if valid is None or valid >= y.shape[0]:
        return y
    y = y.clone()
    y[valid:] = 0
    return y


def centered_matmul(x, m, means, valid: int | None = None):
    """``(X − 1μᵀ)·M`` without materializing the centered X; rows from
    ``valid`` on (zero padding) come out zero.

    >>> g = torch.Generator().manual_seed(0)
    >>> x = torch.randn(6, 3, generator=g, dtype=torch.float64)
    >>> m = torch.randn(3, 2, generator=g, dtype=torch.float64)
    >>> mu = x.mean(0)
    >>> bool(torch.allclose(centered_matmul(x, m, mu), (x - mu) @ m))
    True
    """
    return mask_rows(mdot(x, m) - mdot(means, m)[None, :], valid)


def centered_rmatmul(x, q, means):
    """``(X − 1μᵀ)ᴴ·Q``; ``q`` must already be zero on padded rows."""
    return mdot(x.mH, q) - torch.outer(means.conj(), q.sum(0))


def abs2(t):
    """``|t|²`` elementwise, real: ``t·t`` for real ``t`` (bitwise the
    plain square)."""
    return t.abs() ** 2 if t.is_complex() else t * t


# Mean-domination guard for the analytic total variance: subtracting
# n·‖μ‖² from ‖X‖²_F loses ~(1 + r) of the input grade at
# r = n·‖μ‖² / ‖Xc‖²_F — measured error ≈ 2·eps·(1 + r) (1.2e-5 at
# r = 87, f32).  The thresholds keep that under the dtype's parity band
# (1e-5 f32 / 1e-10 f64) with ~3× margin; past them the guarded form
# recomputes ‖X − 1μᵀ‖²_F explicitly (one extra data pass, engaged only
# when the data actually is mean-dominated).
_SQNORM_GUARD_RMAX = {torch.float32: 30.0, torch.float64: 3e4}


def guarded_sqnorm_from(sq, means, n: int, x):
    """Total variance from a precomputed ``sq = ‖X‖²_F``: the analytic
    subtraction when safe, an explicit centered pass past the
    mean-domination threshold (one host read of the ratio decides).
    ``x`` is the data, or a zero-argument callable that makes the
    explicit pass (the sharded fits' masked, reduced one)."""
    msq = n * abs2(means).sum()
    tv = sq - msq
    rmax = _SQNORM_GUARD_RMAX[tv.dtype]
    r = msq / torch.clamp(tv, min=1e-30)
    if float(r) > rmax:
        return x() if callable(x) else abs2(x - means).sum()
    return tv


def centered_sqnorm_guarded(x, means, n: int):
    """``‖X − 1μᵀ‖²_F`` with the mean-domination guard."""
    return guarded_sqnorm_from(abs2(x).sum(), means, n, x)
