"""One-sided Jacobi SVD — the counterpart of
``petal_decomposition_tpu/ops/jacobi.py`` (``jacobi_svd`` and its plain
core; the two-sided ``jacobi_eigh`` is not on the port's path).

:func:`jacobi_svd` transposes so that m ≥ n, then takes the first rung
of the JAX package's ladder (``jacobi.py:344-400``) that fits, by dtype,
device and the kernels' ``supports()`` alone (:func:`_route`):

1. ``"k2"``: float32 on CUDA within K2's reach (the JAX kernel's
   gate) → the hand-written kernel ``kernels/jacobi_kernels.py``;
2. ``"k3"``: float64 on CUDA within K3's reach →
   ``kernels/jacobi_f64_kernel.py``;
3. ``"qr_k3"``: tall float64 on CUDA (m ≥ 3n) whose n×n R factor K3
   takes → Householder QR, K3 on R, then Q·R_rot;
4. ``"qr_k2"``: float32 on CUDA whose R factor K2 takes → the same
   with K2;
5. ``"torch"``: anything else on CUDA → cuSOLVER's ``gesvd``
   (``linalg.torch_svd``), the counterpart of the JAX package's
   backward-stable QDWH route there;
6. ``"qr_plain"`` / ``"plain"``: the CPU → the plain
   :func:`_jacobi_svd_core`, QR-preconditioned for large tall inputs
   (m ≥ 3n and m·n ≥ 2²⁰), which is what the JAX package runs off the
   TPU and what makes float64 parity at 1e-10 possible.

A kernel that fails to build or launch raises; no rung catches it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import config
from .kernels import jacobi_f64_kernel, jacobi_kernels

__all__ = ["jacobi_svd", "round_robin_pairings"]


@functools.lru_cache(maxsize=None)
def round_robin_pairings(n: int) -> np.ndarray:
    """Static (n-1, n//2, 2) round-robin schedule covering all pairs.

    ``n`` must be even.  Player 0 is fixed; the rest rotate (circle
    method).  Each of the n-1 rounds pairs every index exactly once.
    """
    if n % 2 or n < 2:
        raise ValueError(f"round-robin needs an even n >= 2, got {n}")
    players = list(range(n))
    rounds = []
    for _ in range(n - 1):
        rounds.append(
            [(players[i], players[n - 1 - i]) for i in range(n // 2)]
        )
        players = [players[0], players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int64)


def _rotation_params(app, aqq, apq, skip_thresh):
    """Real 2×2 symmetric eigen-rotation parameters, vectorized over
    pairs: ``(c, s, phase)`` with the rotation [[c, s·phase],
    [-s·phase, c]].  Rotations with ``|apq| <= skip_thresh`` are the
    identity, which also guards zero (padding) columns."""
    absq = apq.abs()
    phase = torch.where(apq >= 0, 1.0, -1.0).to(apq.dtype)
    skip = absq <= skip_thresh
    denom = torch.where(skip, 1.0, 2.0 * torch.where(absq > 0, absq, 1.0))
    tau = (aqq - app) / denom
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)  # tau==0, apq!=0 → 45° rotation
    t = torch.where(skip, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t, phase


def _offdiag_measure(a: torch.Tensor) -> torch.Tensor:
    """Max off-diagonal of AᵀA relative to the largest column norm² —
    a norm-wise convergence functional (a pairwise-relative one stalls
    on numerically-zero columns)."""
    from .linalg import mdot

    g = mdot(a.mT, a)
    dmax = torch.diagonal(g).max()
    absoff = (g - torch.diag(torch.diagonal(g))).abs().max()
    return absoff / torch.where(dmax > 0, dmax, 1.0)


def _jacobi_svd_core(a: torch.Tensor, *, max_sweeps: int):
    """One-sided Jacobi on the columns of ``a`` (m×n, real).

    Returns ``(a_rot, v, off, sweeps)``: at convergence the columns of
    ``a_rot`` are uᵢ·σᵢ and ``v`` holds the right singular vectors.
    The JAX package's ``"scatter"`` update, vectorized over the n/2
    disjoint pairs of each round; its ``"matmul"`` form exists to keep a
    TPU's matrix unit busy and computes the same rotations.
    """
    m, n = a.shape
    eps = float(torch.finfo(a.dtype).eps)
    tol = eps * np.sqrt(max(m, n))
    padded = n % 2 == 1
    a = a.clone()
    if padded:
        a = torch.cat([a, a.new_zeros(m, 1)], dim=1)
        n += 1
    pairs = torch.from_numpy(round_robin_pairings(n)).to(a.device)
    v = torch.eye(n, dtype=a.dtype, device=a.device)
    off = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    sweeps = 0
    while sweeps < max_sweeps and float(off) > tol:
        for pq in pairs:
            p, q = pq[:, 0], pq[:, 1]
            ap, aq = a[:, p], a[:, q]
            app = (ap * ap).sum(0)
            aqq = (aq * aq).sum(0)
            apq = (ap * aq).sum(0)
            # Per-pair relative threshold (de Rijk).
            c, s, phase = _rotation_params(
                app, aqq, apq, eps * torch.sqrt((app * aqq).abs())
            )
            sp = s * phase
            a[:, p] = ap * c - aq * sp
            a[:, q] = ap * sp + aq * c
            vp, vq = v[:, p], v[:, q]
            v[:, p] = vp * c - vq * sp
            v[:, q] = vp * sp + vq * c
        off = _offdiag_measure(a)
        sweeps += 1
    if padded:
        a = a[:, :-1]
        v = v[:-1, :-1]
    return a, v, off, sweeps


def _route(m: int, n: int, dtype: torch.dtype, device_type: str) -> str:
    """The rung of :func:`jacobi_svd`'s ladder an m×n panel (m ≥ n)
    takes — see the module docstring."""
    n_pad = n + (n % 2)
    if device_type == "cuda":
        if jacobi_kernels.supports(m, n, dtype):
            return "k2"
        if jacobi_f64_kernel.supports(m, n, dtype):
            return "k3"
        if m >= 3 * n and jacobi_f64_kernel.supports(n_pad, n, dtype):
            return "qr_k3"
        if jacobi_kernels.supports(n_pad, n, dtype):
            return "qr_k2"
        return "torch"
    if m >= 3 * n and m * n >= (1 << 20):
        return "qr_plain"
    return "plain"


def _rotate(route: str, a: torch.Tensor, max_sweeps: int):
    """``(q, a_rot, v, off, sweeps)`` for an m×n panel (m ≥ n) by
    ``route``: the columns of ``q·a_rot`` (of ``a_rot`` where ``q`` is
    None) are uᵢ·σᵢ in no particular order, ``sweeps`` is -1 where the
    route does not count them.  A ``"qr_"`` route runs the rest of its
    name on the n×n R factor of a Householder QR and returns Q beside
    the rotated R, so σ come from R's n-entry columns: in float32 the
    norms of the m-row columns of Q·R_rot would cost ~1e-4 relative at
    a million rows."""
    if route.startswith("qr_"):
        q, r = torch.linalg.qr(a, mode="reduced")
        _, r_rot, v, off, sweeps = _rotate(route[3:], r, max_sweeps)
        return q, r_rot, v, off, sweeps
    if route == "k2":
        a_rot, v, off = jacobi_kernels.jacobi_svd_vmem(
            a, max_sweeps=max_sweeps
        )
        return None, a_rot, v, off, -1
    if route == "k3":
        a_rot, v, off = jacobi_f64_kernel.jacobi_svd_vmem_f64(
            a, max_sweeps=max_sweeps
        )
        return None, a_rot, v, off, -1
    if route == "torch":
        from .linalg import torch_svd

        u_f, s_f, vt_f = torch_svd(a)
        off = torch.zeros((), dtype=a.dtype, device=a.device)
        return None, u_f * s_f[None, :], vt_f.mT, off, -1
    return (None, *_jacobi_svd_core(a, max_sweeps=max_sweeps))


def jacobi_svd(a: torch.Tensor, *, max_sweeps: int | None = None):
    """Thin SVD via one-sided Jacobi: ``a = U diag(s) Vᵀ``.

    Returns ``(u, s, vt, off, sweeps)`` with u: (m, k), s: (k,)
    descending, vt: (k, n), k = min(m, n); ``off`` is the convergence
    certificate and ``sweeps`` is -1 where the route does not count
    them.  For m < n the problem is transposed internally — for the
    randomized fit's l×d panel B that hands the kernel B's rows as the
    columns it rotates, with no copy.
    """
    if a.is_complex():
        raise NotImplementedError("the port's Jacobi SVD is real-only")
    m, n = a.shape
    if max_sweeps is None:
        max_sweeps = config.jacobi_max_sweeps
    transposed = m < n
    if transposed:
        a = a.mT
        m, n = n, m
    q, a_rot, v, off, sweeps = _rotate(
        _route(m, n, a.dtype, a.device.type), a, max_sweeps
    )
    s = torch.sqrt((a_rot * a_rot).sum(0))
    order = torch.argsort(-s, stable=True)
    s = s[order]
    u = a_rot[:, order] / torch.where(s > 0, s, 1.0)
    if q is not None:
        from .linalg import mdot

        u = mdot(q, u)  # U = Q·(R_rot·σ⁻¹)
    w = v[:, order]
    if transposed:
        # a_original = (U diag(s) Vᵀ)ᵀ = V diag(s) Uᵀ
        u, w = w, u
    return u, s, w.mT, off, sweeps
