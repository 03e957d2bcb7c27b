"""Linalg layer of the port — the counterpart of
``petal_decomposition_tpu/ops/linalg.py``.

The same surface dispatches between two interchangeable routes:

* the in-house one-sided Jacobi SVD (:mod:`.jacobi`) — the hand-written
  Hopper kernels K2 (float32) and K3 (float64) on CUDA, directly or on
  the R factor of a tall QR, and the plain PyTorch transcription of the
  JAX package's ``_jacobi_svd_core`` off the card;
* ``torch.linalg`` (LAPACK on the CPU, cuSOLVER on CUDA) — the
  counterpart of the JAX package's XLA built-ins, and the route of
  every complex factorization (the kernels are real-only).

A tensor's ``device.type`` takes the place of the JAX package's
``effective_platform()``: ``"cuda"`` is the accelerator, ``"cpu"`` the
CPU.  Every float32 matmul runs in IEEE float32 (TF32 off): see
:func:`ieee_f32`.
"""

from __future__ import annotations

import contextlib

import torch

from ..config import config
from ..errors import LinalgError
from .jacobi import jacobi_svd
from .kernels import jacobi_f64_kernel

__all__ = [
    "svd",
    "svddc",
    "svd_jit_cert",
    "eigh_psd_jit_cert",
    "eigh_psd_jit",
    "qr",
    "cholesky_qr2",
    "lu_pl",
    "svd_flip",
    "torch_svd",
    "mdot",
    "ieee_f32",
    "convergence_tol",
    "check_certificate",
]


@contextlib.contextmanager
def ieee_f32():
    """Run float32 matmuls inside the block in IEEE float32.

    Sets PyTorch's float32 matmul precision to ``config.matmul_precision``
    (``"highest"``: TF32 off) for the duration of the block, asserts it
    took effect, and restores the caller's setting afterwards — the
    process-wide flag is never left flipped.
    """
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision(config.matmul_precision)
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is still enabled for float32 matmuls")
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def mdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matmul at the configured precision (``"highest"``: IEEE float32).

    >>> a = torch.arange(6.0).reshape(2, 3)
    >>> bool(torch.allclose(mdot(a, a.T), a @ a.T))
    True
    """
    with ieee_f32():
        return a @ b


def _use_jacobi(dtype: torch.dtype, device: torch.device) -> bool:
    if dtype.is_complex:
        return False  # the Jacobi routes are real-only
    backend = config.linalg_backend
    if backend == "jacobi":
        return True
    if backend == "torch":
        return False
    if dtype == torch.float64:
        return True  # in-house route meets the 1e-10 parity band
    # float32: the Jacobi kernel on the card, LAPACK on the CPU (the JAX
    # package keeps LAPACK on its CPU placement likewise).
    return device.type != "cpu"


def _check_converged(off, tol: float, what: str) -> None:
    # ``not (off <= tol)`` so a NaN certificate FAILS the check (LAPACK
    # info != 0 analogue; ref: linalg.rs:84, 115).
    if config.check_convergence and not (float(off) <= tol):
        raise LinalgError(f"{what} did not converge")


def convergence_tol(dtype: torch.dtype, dim: int) -> float:
    """Host-side tolerance for a Jacobi off-diagonal certificate (the JAX
    package's formula, whose 2⁻⁴⁵ floor serves its df64 kernel)."""
    return max(float(torch.finfo(dtype).eps) * 4, 2.0 ** -45) * (dim ** 0.5)


def check_certificate(off, dtype: torch.dtype, dim: int, what: str) -> None:
    """Raise ``LinalgError`` when a convergence certificate exceeds its
    tolerance — the LAPACK ``info != 0`` analogue (ref: linalg.rs:84,115)."""
    _check_converged(off, convergence_tol(dtype, dim), what)


def _eigh_psd_k3(a: torch.Tensor):
    """``(λ ascending, v, off)`` of a float64 PSD matrix by K3 on its
    symmetrized copy: for a PSD matrix the one-sided Jacobi's σ are the
    eigenvalues and its right vectors the eigenvectors, so λ are the
    rotated columns' norms (``petal_decomposition_tpu/ops/linalg.py:
    193-216``).  Symmetrizing gives LAPACK's one-triangle semantics: a
    Gram from a matmul is not bitwise symmetric.  On a CPU tensor K3's
    wrapper runs its plain version."""
    a = (a + a.mT) / 2
    a_rot, v, off = jacobi_f64_kernel.jacobi_svd_vmem_f64(
        a, max_sweeps=config.jacobi_max_sweeps
    )
    lam = torch.sqrt((a_rot * a_rot).sum(0))
    order = torch.argsort(lam, stable=True)  # ascending, LAPACK's order
    return lam[order], v[:, order], off


def eigh_psd_jit_cert(a: torch.Tensor):
    """Eigendecomposition of a positive-semidefinite symmetric matrix:
    ``(w ascending, v, off)``.

    float64 on CUDA within K3's reach (n×n, n ≤ 512) → K3 on the
    symmetrized matrix (:func:`_eigh_psd_k3`), the JAX package's TPU
    route; ``off`` is its certificate.  Everything else →
    ``torch.linalg.eigh`` (LAPACK, cuSOLVER), as the JAX package
    delegates float32 to XLA's eigh; ``off`` is 0 there.
    """
    n = a.shape[0]
    if (
        config.linalg_backend in ("auto", "jacobi")
        and a.is_cuda
        and jacobi_f64_kernel.supports(n, n, a.dtype)
    ):
        return _eigh_psd_k3(a)
    w, v = torch.linalg.eigh(a)
    return w, v, torch.zeros((), dtype=w.dtype, device=w.device)


def eigh_psd_jit(a: torch.Tensor):
    """:func:`eigh_psd_jit_cert` without the certificate."""
    w, v, _ = eigh_psd_jit_cert(a)
    return w, v


def torch_svd(a: torch.Tensor):
    """``torch.linalg.svd`` (thin): LAPACK on the CPU; on CUDA cuSOLVER's
    QR-bidiagonalization ``gesvd``, oriented m ≥ n as it requires.
    cuSOLVER's default for one matrix, the Jacobi ``gesvdj``,
    reconstructs a float32 4096×200 panel only to 3.3e-5 (gesvd: 2.5e-6;
    float64 1500×600: 2.2e-13 against 6.9e-15), measured on an NVIDIA
    H100 80GB HBM3 at 700 W.

    >>> a = torch.arange(6.0, dtype=torch.float64).reshape(2, 3)
    >>> u, s, vt = torch_svd(a)
    >>> bool(((u * s) @ vt - a).abs().max() < 1e-12)
    True
    """
    if not a.is_cuda:
        return torch.linalg.svd(a, full_matrices=False)
    if a.shape[0] < a.shape[1]:
        u, s, vh = torch_svd(a.mH)
        return vh.mH, s, u.mH
    return torch.linalg.svd(a, full_matrices=False, driver="gesvd")


def svd_jit_cert(a: torch.Tensor):
    """Backend-dispatched thin SVD with its convergence certificate:
    ``(u, s, vt, off)``; ``off`` is 0 for ``torch.linalg``, which also
    takes every complex input."""
    if _use_jacobi(a.dtype, a.device):
        u, s, vt, off, _ = jacobi_svd(a)
        return u, s, vt, off
    u, s, vt = torch_svd(a)
    return u, s, vt, torch.zeros((), dtype=s.dtype, device=s.device)


def svd(a: torch.Tensor, compute_vt: bool = True):
    """Thin SVD ``a = U diag(s) Vᵀ`` (reference ``svd``/gesvd,
    linalg.rs:70-91); raises ``LinalgError`` on non-convergence.

    >>> a = torch.randn(40, 6, generator=torch.Generator().manual_seed(0),
    ...                 dtype=torch.float64)
    >>> u, s, vt = svd(a)
    >>> tuple(u.shape), tuple(s.shape), tuple(vt.shape)
    ((40, 6), (6,), (6, 6))
    >>> bool(((u * s) @ vt - a).abs().max() < 1e-10)
    True
    """
    if _use_jacobi(a.dtype, a.device):
        u, s, vt, off, _ = jacobi_svd(a)
        check_certificate(
            off, s.dtype, max(a.shape), "singular value decomposition"
        )
    else:
        u, s, vt = torch_svd(a)
    return u, s, (vt if compute_vt else None)


def svddc(a: torch.Tensor):
    """Economy SVD of a small projected matrix (reference ``svddc``/gesdd,
    linalg.rs:101-122): :func:`svd` that always returns vt."""
    return svd(a, compute_vt=True)


def qr(a: torch.Tensor) -> torch.Tensor:
    """Economy QR: orthonormal basis of range(a), shape (m, min(m, n))
    (reference linalg.rs:127-147)."""
    return torch.linalg.qr(a, mode="reduced").Q


def cholesky_qr2(a: torch.Tensor) -> torch.Tensor:
    """Tall-skinny orthonormalization via CholeskyQR2: two rounds of
    ``Q = A·chol(AᵀA)⁻ᵀ``, all work in matmuls.

    >>> g = torch.Generator().manual_seed(2)
    >>> q = cholesky_qr2(torch.randn(64, 5, generator=g, dtype=torch.float64))
    >>> bool((q.T @ q - torch.eye(5, dtype=q.dtype)).abs().max() < 1e-12)
    True
    """

    def one_round(x):
        g = mdot(x.mH, x)
        k = g.shape[0]
        eye = torch.eye(k, dtype=g.dtype, device=g.device)
        eps = float(torch.finfo(g.dtype).eps)
        trace = torch.diagonal(g).sum()
        # Tiny diagonal lift for exactly rank-deficient panels, floored
        # so it cannot underflow to 0 on an all-zero panel.
        lift = torch.clamp(eps * trace / k, min=1e-30)
        low, info = torch.linalg.cholesky_ex(g + lift * eye)
        # Escalating shift (shifted CholeskyQR, Fukaya et al.) for Grams
        # whose rounding makes G + lift indefinite; engaged only when
        # the first factorization failed, and selected without a host
        # sync, as the JAX package selects it in-graph.
        u = max(eps, 2.0 ** -48)
        big = torch.clamp((u ** 0.5) * trace, min=1e-30)
        low_big, _ = torch.linalg.cholesky_ex(g + big * eye)
        bad = (info != 0) | torch.isnan(low).any()
        low = torch.where(bad, low_big, low)
        # Q = X·L⁻ᴴ through a k×k triangular inverse and one matmul.
        linv = torch.linalg.solve_triangular(low, eye, upper=False)
        return mdot(x, linv.mH)

    return one_round(one_round(a))


def lu_pl(a: torch.Tensor) -> torch.Tensor:
    """Partial-pivot LU, returning the ``P·L`` factor (m × min(m, n)) —
    ``lair``'s ``into_pl`` as the Halko power-iteration normalizer uses
    it (ref: pca.rs:709-713).  The JAX package hand-rolls the
    elimination because XLA's LU is float32-only on a TPU; here LAPACK's
    (or cuSOLVER's) ``getrf`` does it.

    >>> g = torch.Generator().manual_seed(3)
    >>> pl = lu_pl(torch.randn(30, 4, generator=g, dtype=torch.float64))
    >>> tuple(pl.shape), bool(pl.abs().max() <= 1.0 + 1e-12)
    ((30, 4), True)
    """
    m, n = a.shape
    k = min(m, n)
    # ``_ex``: an exactly singular panel (a zero pivot column) is a valid
    # input here, as in the JAX package's elimination; it must not raise.
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)
    # LAPACK pivots are 1-based sequential row swaps; replay them on an
    # index vector: row perm[i] of A is row i of L·U.
    perm = torch.arange(m, device=a.device)
    for j, p in enumerate(pivots.tolist()):
        p -= 1
        if p != j:
            perm[[j, p]] = perm[[p, j]]
    lower = torch.tril(lu[:, :k], diagonal=-1) + torch.eye(
        m, k, dtype=a.dtype, device=a.device
    )
    pl = torch.empty_like(lower)
    pl[perm] = lower
    return pl


def svd_flip(u: torch.Tensor, vt: torch.Tensor):
    """Deterministic SVD signs (exact port of the reference convention,
    pca.rs:815-850): for each column of ``u`` find the entry of largest
    magnitude — the *first* occurrence wins ties, as in the reference's
    strict ``>`` scan — and if its real part is negative (or, when the
    real part is exactly zero, its imaginary part is negative), negate
    that column of u and row of vt.

    >>> u = torch.tensor([[-0.8], [0.6]]); vt = torch.tensor([[1.0, 2.0]])
    >>> uf, vtf = svd_flip(u, vt)  # pivot -0.8 is negative: both flip
    >>> uf.ravel().tolist(), vtf.ravel().tolist()
    ([0.800000011920929, -0.6000000238418579], [-1.0, -2.0])
    """
    k = min(u.shape[1], vt.shape[0])
    ucols = u[:, :k]
    idx = torch.argmax(ucols.abs(), dim=0)  # first max, like the ref scan
    pivots = torch.gather(ucols, 0, idx[None, :])[0]
    re = pivots.real
    im = pivots.imag if pivots.is_complex() else torch.zeros_like(re)
    # Rust f64::signum: +1 for +0.0; flip only on a negative pivot.
    basis = torch.where(re == 0, im, re)
    signs = torch.where(basis < 0, -1.0, 1.0).to(u.dtype)
    u = u.clone()
    vt = vt.clone()
    u[:, :k] *= signs[None, :]
    vt[:k, :] *= signs[:, None]
    return u, vt
