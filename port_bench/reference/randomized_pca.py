"""Plain randomized PCA: Halko, Martinsson and Tropp (2011), the
randomized range finder with q power iterations (Algorithm 4.3, its
subspace form 4.4) and the direct SVD of B = QᵀXc (Algorithm 5.1).

The data comes as row blocks.  One pass takes the column means, the
squared Frobenius norm of the centered data and its Gram Gc = XcᵀXc; the
rest works on Gc: with W = orth(Gc^q·Ω) and Q = Xc·W·R⁻¹ (RᵀR = WᵀGcW,
Cholesky), B·Bᵀ = R⁻ᵀ·(WᵀGc²W)·R⁻¹, whose eigenpairs give σ² and
B's left vectors Z, and the components are Bᵀ·Z·Σ⁻¹ = Gc·W·R⁻¹·Z·Σ⁻¹.

Signs, as each entry documents them: ``"u_pivot"`` (``fit``, the
reference's ``svd_flip``) makes the largest-|·| entry of each column of
U = Xc·V·Σ⁻¹ positive, the first of equal ones winning; ``"v_pivot"``
(``fit_batched``, which has no U) does so on each component.  Each sign
comes with the relative gap between its pivot's magnitude and the
runner-up's, so that a comparison can tell a decided sign from a tie.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .common import dtype_of, mm, no_tf32


# The columns of U one pass over the blocks pivots at most: a group of
# fits' components shares a pass.
GROUP_COLS = 1024


@dataclass
class Moments:
    n: int
    mean: torch.Tensor
    gram: torch.Tensor  # centered, d × d
    total_variance: torch.Tensor


@dataclass
class Solution:
    sigma: torch.Tensor  # (k,)
    components: torch.Tensor  # (k, d), rows signed
    pivot_gap: torch.Tensor  # (k,)
    mean: torch.Tensor
    evr: torch.Tensor  # (k,)
    gram: torch.Tensor  # the centered Gram of the fit's data (shared)


def moments(blocks, precision: str) -> Moments:
    """Means, centered Gram and total variance from one pass over the
    row blocks (``XᵀX − n·μμᵀ``, each block's products at ``precision``)."""
    dt = dtype_of(precision)
    n, s, sq, g = 0, None, None, None
    with no_tf32():
        for b in blocks:
            c = b.to(dt)
            if g is None:
                d = c.shape[1]
                s = torch.zeros(d, dtype=dt, device=c.device)
                sq = torch.zeros((), dtype=dt, device=c.device)
                g = torch.zeros((d, d), dtype=dt, device=c.device)
            n += c.shape[0]
            s += c.sum(0)
            sq += (c * c).sum()
            g += mm(c.mT, c, precision)
            del c
    mean = s / n
    gc = g - n * torch.outer(mean, mean)
    return Moments(n, mean, (gc + gc.mT) / 2, sq - n * (mean * mean).sum())


def subspace(m: Moments, omega: torch.Tensor, k: int, n_power_iters: int,
             precision: str):
    """``(σ, V)``: the top ``k`` singular values and right vectors (as
    columns, unsigned) of the randomized SVD with test matrix ``omega``
    (d × l)."""
    dt = dtype_of(precision)
    g = m.gram
    with no_tf32():
        w = torch.linalg.qr(omega.to(g.device, dt)).Q
        for _ in range(n_power_iters):
            w = torch.linalg.qr(mm(g, w, precision)).Q
        gw = mm(g, w, precision)
        m1 = mm(w.mT, gw, precision)
        r = torch.linalg.cholesky((m1 + m1.mT) / 2, upper=True)
        eye = torch.eye(r.shape[0], dtype=dt, device=r.device)
        r_inv = torch.linalg.solve_triangular(r, eye, upper=True)
        m2 = mm(gw.mT, gw, precision)
        c = mm(r_inv.mT, mm((m2 + m2.mT) / 2, r_inv, precision), precision)
        lam, z = torch.linalg.eigh((c + c.mT) / 2)
        lam, z = lam.flip(0)[:k], z.flip(1)[:, :k]
        sigma = lam.clamp(min=0).sqrt()
        v = mm(gw, mm(r_inv, z, precision), precision) / sigma[None, :]
    return sigma, v


def eigen_residual(components: torch.Tensor, sigma: torch.Tensor,
                   gram: torch.Tensor, scale: float) -> torch.Tensor:
    """Per row v of ``components`` with its σ: the larger of
    ‖Gc·v − σ²·v‖ / ``scale`` and |‖v‖ − 1|, in ``gram``'s precision.
    0 for an exact right singular vector of Xc with its singular value,
    whatever the start or the eigengaps; a vector of another singular
    value, or one of the wrong length, reads large."""
    with no_tf32():
        v = components.to(gram)
        s2 = sigma.to(gram) ** 2
        r = (v @ gram - s2[:, None] * v).norm(dim=1) / scale
        return torch.maximum(r, (v.norm(dim=1) - 1.0).abs())


def _top2(a: torch.Tensor):
    """Per column of ``a``: the signed entry of largest magnitude (the
    first of equal ones), its magnitude and the runner-up's."""
    mag = a.abs()
    top = mag.topk(min(2, a.shape[0]), dim=0)
    first = torch.argmax(mag, dim=0)
    signed = torch.gather(a, 0, first[None, :])[0]
    second = top.values[1] if a.shape[0] > 1 else torch.zeros_like(signed)
    return signed, top.values[0], second


def u_pivots(blocks, m: Moments, vs: torch.Tensor, precision: str):
    """``(signs, gaps)`` of the columns of U = Xc·V (σ > 0 does not move
    a sign) for the columns ``vs`` (d × c), one pass over the blocks."""
    best = None
    with no_tf32():
        for b in blocks:
            p = mm(b.to(vs.dtype) - m.mean, vs, precision)
            signed, top, second = _top2(p)
            if best is None:
                best = [signed, top, second]
                continue
            b_signed, b_top, b_second = best
            wins = top > b_top  # strictly: an earlier row keeps a tie
            new_second = torch.where(wins, torch.maximum(b_top, second),
                                     torch.maximum(b_second, top))
            best = [torch.where(wins, signed, b_signed),
                    torch.where(wins, top, b_top), new_second]
    signed, top, second = best
    return _signs(signed), (top - second) / top


def v_pivots(vs: torch.Tensor):
    """``(signs, gaps)`` of the columns ``vs`` by their own entries."""
    signed, top, second = _top2(vs)
    return _signs(signed), (top - second) / top


def _signs(pivot: torch.Tensor) -> torch.Tensor:
    return torch.where(pivot < 0, -1.0, 1.0).to(pivot.dtype)


def solve(blocks, omegas: dict, k: int, n_power_iters: int, signs: str,
          precision: str) -> dict:
    """``{fit: Solution}`` for each test matrix in ``omegas``.
    ``blocks`` is a callable returning a fresh iterator of row blocks."""
    m = moments(blocks(), precision)
    raw = {i: subspace(m, om, k, n_power_iters, precision)
           for i, om in omegas.items()}
    fits = list(raw)
    sign_of, gap_of = {}, {}
    per = max(1, GROUP_COLS // k)
    for g0 in range(0, len(fits), per):
        group = fits[g0:g0 + per]
        vs = torch.cat([raw[i][1] for i in group], dim=1)
        if signs == "u_pivot":
            sg, gap = u_pivots(blocks(), m, vs, precision)
        elif signs == "v_pivot":
            sg, gap = v_pivots(vs)
        else:
            raise ValueError(f"unknown sign rule {signs!r}")
        for j, i in enumerate(group):
            sign_of[i] = sg[j * k:(j + 1) * k]
            gap_of[i] = gap[j * k:(j + 1) * k]
    out = {}
    for i, (sigma, v) in raw.items():
        comps = (v * sign_of[i][None, :]).mT
        out[i] = Solution(sigma, comps, gap_of[i], m.mean,
                          sigma * sigma / m.total_variance, m.gram)
    return out
