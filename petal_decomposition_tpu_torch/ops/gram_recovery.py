"""Gram-side randomized-SVD recovery — the counterpart of
``petal_decomposition_tpu/ops/gram_recovery.py``: the d-space algebra
the Gram range finder needs once the data is reduced to
``Gc = XcᵀXc``.

- :func:`gram_subspace` — the subspace iteration ``qr((Gc)^q·Ω)``
  (the Gram-side form of the reference's power iteration,
  pca.rs:708-715).
- :func:`randomized_gram_recovery` — the in-core finder's exact
  recovery (B = QᵀXc, pca.rs:681-684) rebuilt from Gc's l×l algebra
  with no pass over the data; σ come out unsquared.
- :func:`flip_components` — the U-free deterministic sign convention.
"""

from __future__ import annotations

import torch

from .linalg import eigh_psd_jit_cert, mdot

__all__ = [
    "flip_components",
    "gram_subspace",
    "randomized_gram_recovery",
]


def flip_components(vt):
    """Deterministic per-component signs without U: the largest-|·|
    entry of each component (first occurrence wins ties, mirroring the
    reference's strict ``>`` scan) is made non-negative.

    >>> vt = torch.tensor([[0.6, -0.8], [-0.8, 0.6]], dtype=torch.float64)
    >>> flip_components(vt).tolist()
    [[-0.6, 0.8], [0.8, -0.6]]
    """
    idx = torch.argmax(vt.abs(), dim=1)
    piv = torch.gather(vt, 1, idx[:, None])[:, 0]
    signs = torch.where(piv < 0, -1.0, 1.0).to(vt.dtype)
    return vt * signs[:, None]


def gram_subspace(g_sub, omega, n_power_iters: int):
    """``qr((G)^q · Ω)`` — power iterations on the d×d operator with a
    Householder QR after each application (one G application squares
    the condition number, beyond CholeskyQR2's reach).

    >>> g = torch.diag(torch.tensor([9.0, 4.0, 1.0]))
    >>> w = gram_subspace(g, torch.ones(3, 1), 8)
    >>> bool(abs(float(w[0, 0].abs()) - 1.0) < 1e-5)  # top eigvec
    True
    """
    w = omega
    for _ in range(n_power_iters):
        w = torch.linalg.qr(mdot(g_sub, w), mode="reduced").Q
    return w


def randomized_gram_recovery(gc, omega, *, n_power_iters: int):
    """The in-core finder's EXACT recovery, reconstructed from G alone.

    With ``M₁ = WᵀGW`` (= (XW)ᵀ(XW)) and ``M₂ = WᵀG²W``, the symmetric
    whitener ``S = M₁^(−1/2)`` makes ``Q = X·W·S`` orthonormal and
    ``B·Bᵀ = S·M₂·S``, so σ² are its eigenvalues and the feature-space
    right vectors are ``v_j = G·W·S·z_j / σ_j``.  ``S`` is built by eigh
    with a pseudo-inverse cutoff, so rank-deficient sketches degrade to
    zero σ instead of NaN.

    Returns ``(sigma, vt, off)``: σ descending (length l), component
    rows ``vt`` (l×d, orthonormal, :func:`flip_components` signs), and
    the max eigh certificate of the two l×l solves.
    """
    w = torch.linalg.qr(omega, mode="reduced").Q
    w = gram_subspace(gc, w, n_power_iters)
    gw = mdot(gc, w)  # (d, l)
    m1 = mdot(w.mT, gw)
    m1 = (m1 + m1.mT) / 2
    m2 = mdot(gw.mT, gw)
    m2 = (m2 + m2.mT) / 2
    lam1, e1, off1 = eigh_psd_jit_cert(m1)  # ascending
    lam1 = torch.clamp(lam1, min=0)
    cut = lam1[-1] * torch.finfo(lam1.dtype).eps * m1.shape[0]
    ok = lam1 > cut
    inv_sqrt = torch.where(
        ok, 1.0 / torch.sqrt(torch.where(ok, lam1, 1.0)), 0.0
    )
    s_half = e1 * inv_sqrt[None, :]  # S = s_half·e1ᵀ
    c = mdot(s_half.mT, mdot(m2, s_half))  # e1-basis form of S·M₂·S
    c = (c + c.mT) / 2
    lam2, z, off2 = eigh_psd_jit_cert(c)  # ascending
    sigma = torch.sqrt(torch.clamp(lam2.flip(0), min=0))
    inv_sigma = torch.where(
        sigma > 0, 1.0 / torch.where(sigma > 0, sigma, 1.0), 0.0
    )
    # v_j = G·W·S·z_j/σ_j; S·z (in the original basis) = s_half·z.
    v = mdot(gw, mdot(s_half, z.flip(1))) * inv_sigma[None, :]
    # Re-orthonormalize: float orthogonality of v degrades with κ(M₁);
    # a thin QR restores orthonormal rows and completes dead directions.
    v = torch.linalg.qr(v, mode="reduced").Q
    return sigma, flip_components(v.mT), torch.maximum(off1, off2)
