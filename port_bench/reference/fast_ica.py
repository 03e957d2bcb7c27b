"""Plain symmetric FastICA (Hyvärinen and Oja 2000) with the logcosh
contrast, whitened by the eigendecomposition of the centered Gram, as the
configuration states it: X₁ = K·Xcᵀ·√n with K = Λ^(−1/2)·Eᵀ, the update
W ← sym(g(WX₁)·X₁ᵀ/n − diag(mean g′(WX₁))·W), sym(W) = (WWᵀ)^(−1/2)·W,
and the reference implementation's stop test
max_i ||row_i(W₁)·col_i(W)| − 1| < tol within ``max_iter`` steps.

:func:`fixed_point_residual` judges unmixing rows by what they say: it
maps them into this whitening (W = C·E·Λ^(1/2), exact for k ≤ d since
K·E·Λ^(1/2) = I) and measures how far one update moves them, row by row
and up to the sign the update may flip.  It does not depend on the start,
the signs the whitening's eigensolver chose, or the order of the rows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .common import dtype_of, mm, no_tf32


@dataclass
class Whitening:
    mean: torch.Tensor  # (d,)
    k_mat: torch.Tensor  # (k, d)
    back: torch.Tensor  # (d, k): E·Λ^(1/2), with k_mat·back = I
    x1: torch.Tensor  # (k, n)
    col_std: torch.Tensor  # (d,)


def whiten(x: torch.Tensor, k: int, precision: str) -> Whitening:
    dt = dtype_of(precision)
    with no_tf32():
        xd = x.to(dt)
        n = xd.shape[0]
        mean = xd.mean(0)
        xc = xd - mean
        g = mm(xc.mT, xc, precision)
        lam, e = torch.linalg.eigh((g + g.mT) / 2)
        lam, e = lam.flip(0)[:k], e.flip(1)[:, :k]
        k_mat = (e / lam.sqrt()[None, :]).mT
        x1 = mm(k_mat, xc.mT, precision) * math.sqrt(n)
        back = e * lam.sqrt()[None, :]
        col_std = (torch.diagonal(g) / n).sqrt()
    return Whitening(mean, k_mat, back, x1, col_std)


def sym_decorrelation(w: torch.Tensor, precision: str) -> torch.Tensor:
    lam, v = torch.linalg.eigh(mm(w, w.mT, precision))
    lam = lam.clamp(min=torch.finfo(lam.dtype).tiny)
    return mm(v * lam.rsqrt()[None, :], mm(v.mT, w, precision), precision)


def update(w: torch.Tensor, x1: torch.Tensor, precision: str) -> torch.Tensor:
    """One fixed-point step of W on the whitened rows ``x1`` (logcosh)."""
    n = x1.shape[1]
    with no_tf32():
        t = torch.tanh(mm(w, x1, precision))
        gx = mm(t, x1.mT, precision) / n
        gp = (1.0 - t * t).mean(1)
        return sym_decorrelation(gx - gp[:, None] * w, precision)


def fit(x: torch.Tensor, w_init: torch.Tensor, k: int, max_iter: int,
        tol: float, precision: str):
    """``(components (k × d), mean, n_iter)`` of the fit from ``w_init``."""
    wh = whiten(x, k, precision)
    with no_tf32():
        w = sym_decorrelation(w_init.to(wh.x1), precision)
        it = 0
        while it < max_iter:
            w1 = update(w, wh.x1, precision)
            lim = float(((w1 * w.mT).sum(1).abs() - 1.0).abs().max())
            w, it = w1, it + 1
            if lim < tol:
                break
        return mm(w, wh.k_mat, precision), wh.mean, it


def pseudo_inverse(c: torch.Tensor, precision: str) -> torch.Tensor:
    """C⁺ of a k × d unmixing of full row rank, Cᵀ·(C·Cᵀ)⁻¹, with its
    operands at ``precision``."""
    with no_tf32():
        cc = mm(c, c.mT, precision)
        return mm(c.mT, torch.linalg.inv((cc + cc.mT) / 2), precision)


def fixed_point_residual(components: torch.Tensor, wh: Whitening) -> float:
    """max over rows of min over s = ±1 of max |update(W)ᵢ − s·Wᵢ|, with
    W = C·E·Λ^(1/2), in the whitening's precision."""
    with no_tf32():
        w = components.to(wh.x1) @ wh.back
        w1 = update(w, wh.x1, "float64" if wh.x1.dtype == torch.float64
                    else "float32")
        s = torch.where((w1 * w).sum(1) < 0, -1.0, 1.0).to(w.dtype)
        return float((w1 - s[:, None] * w).abs().max())
