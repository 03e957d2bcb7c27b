"""The PCA fit pipelines — the single-device parts of
``petal_decomposition_tpu/parallel/distributed.py`` (the path is kept so
a reader finds the counterpart): ``randomized_pca_fit`` and the exact
Gram solver ``pca_fit_gram``.

The JAX module expresses every fit as one jitted computation over a
row-sharded matrix; this port runs the same pipeline eagerly on one
device.  The mesh parts — row sharding with padded-row masks
(``n_valid``), the per-shard kernel under ``shard_map``, the psums that
become ``torch.distributed.all_reduce`` — come in a later port, as does
``fast_ica_fit``.  The JAX package's in-graph
``lax.cond`` guards become host-side branches on one scalar each.

Every ``gram_precision`` grade runs the Gram in IEEE float32 (TF32 off,
:func:`..ops.linalg.ieee_f32`) in this port; which Hopper grade each
should map to is settled by measurement.  ``_GRAM_GUARD_RMAX`` keeps the
JAX package's thresholds, which were rated for one bf16 pass and so are
conservative at float32.
"""

from __future__ import annotations

import torch

from ..ops.centered import (
    _SQNORM_GUARD_RMAX,
    abs2,
    centered_matmul,
    centered_rmatmul,
    centered_sqnorm_guarded,
    guarded_sqnorm_from,
)
from ..ops.gram_recovery import (
    gram_subspace as _gram_subspace,
    randomized_gram_recovery,
)
from ..ops.kernels import sketch_kernel
from ..ops.linalg import (
    cholesky_qr2,
    eigh_psd_jit_cert,
    ieee_f32,
    lu_pl,
    mdot,
    svd_flip,
    svd_jit_cert,
)

__all__ = ["pca_fit_gram", "randomized_pca_fit"]


def _masked_center(x, centering: bool):
    """Explicit (non-fused) centering: ``(means, x − means)``."""
    if centering:
        means = x.sum(0) / x.shape[0]
        return means, x - means
    return torch.zeros(x.shape[1], dtype=x.dtype, device=x.device), x


def _contractions(x, centering: bool, fuse_centering: bool):
    """Returns ``(means, xm, xtm, gram, sqnorm)`` closures over the
    centered data, fused or explicit.  ``gram`` is the conjugate Gram
    ``XcᴴXc`` (``XᴴX − n·μ̄μᵀ`` fused)."""
    n = x.shape[0]
    if fuse_centering:
        if centering:
            means = x.sum(0) / n
        else:
            means = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        return (
            means,
            lambda m: centered_matmul(x, m, means),
            lambda q: centered_rmatmul(x, q, means),
            lambda: mdot(x.mH, x) - n * torch.outer(means.conj(), means),
            lambda: centered_sqnorm_guarded(x, means, n),
        )
    means, xc = _masked_center(x, centering)
    return (
        means,
        lambda m: mdot(xc, m),
        lambda q: mdot(xc.mH, q),
        lambda: mdot(xc.mH, xc),
        lambda: abs2(xc).sum(),
    )


def pca_fit_gram(x, *, centering: bool = True):
    """Exact PCA via the covariance eigenproblem (``distributed.py:
    114-177``): ``C = XcᴴXc`` with fused centering, ``eigh(C)``, thin
    ``U = Xc·V·σ⁻¹``.

    Returns the same fields as the SVD path — ``{"u", "sigma", "vt",
    "means", "total_variance", "off"}`` with k = min(n, d) — U/σ/Vᴴ
    reproduce the full-SVD factorization including the deterministic
    ``svd_flip`` signs.  ``off`` is the eigensolve's certificate (K3's
    on CUDA at float64), which the caller checks.
    """
    n, d = x.shape
    means, xm, _, gram, _ = _contractions(x, centering, True)
    c = gram()
    if centering:
        # σ come straight from this Gram: the fused rank-1 centering
        # loses ~(1 + r) of the input grade at r = n‖μ‖²/tr(C), so the
        # exact path uses the tight thresholds of the total-variance
        # guard; past them it rebuilds C from an explicitly centered
        # copy (one host read of r decides).
        tr = torch.diagonal(c).real.sum()
        r = n * (means.abs() ** 2).sum() / torch.clamp(tr, min=1e-30)
        if float(r) > _SQNORM_GUARD_RMAX[tr.dtype]:
            xc = x - means
            c = mdot(xc.mH, xc)
    lam, v, off = eigh_psd_jit_cert(c)  # ascending
    lam = lam.flip(0)
    v = v.flip(1)
    sigma = torch.sqrt(torch.clamp(lam, min=0))
    inv_sigma = torch.where(
        sigma > 0, 1.0 / torch.where(sigma > 0, sigma, 1.0), 0.0
    )
    u = xm(v) * inv_sigma.to(x.dtype)[None, :]
    u, vt = svd_flip(u, v.mH)
    k_full = min(n, d)
    return {
        "u": u[:, :k_full],
        "sigma": sigma[:k_full],
        "vt": vt[:k_full, :],
        "means": means,
        "total_variance": (sigma * sigma).sum(),
        "off": off,
    }


def _resolve_range_finder(range_finder: str, n: int, d: int, l: int,
                          device_type: str, *, full_f64: bool = False,
                          is_complex: bool = False) -> str:
    """``"auto"`` picks the Gram finder on the accelerator when the
    sketch is much narrower than the data (l ≤ d/4) and the data is tall
    (n ≥ 4d and ≥ 32k rows); the CPU, full-float64 and complex fits stay
    direct — the JAX package's accelerator and CPU autos, unchanged.  The
    Gram finder is real-only, as in the JAX package."""
    if range_finder not in ("auto", "direct", "gram"):
        raise ValueError(f"unknown range finder {range_finder!r}")
    if range_finder != "auto":
        if range_finder == "gram" and is_complex:
            raise ValueError("range_finder='gram' supports real dtypes only")
        return range_finder
    if full_f64 or is_complex or device_type == "cpu":
        return "direct"
    if 1 <= l <= d // 4 and n >= 4 * d and n >= 32768:
        return "gram"
    return "direct"


def _resolve_gram_projection(gram_projection: str, range_finder: str,
                             mixed: bool, device_type: str) -> str:
    """``"auto"`` picks the zero-pass Gram-algebra recovery
    (:func:`..ops.gram_recovery.randomized_gram_recovery`) whenever the
    Gram finder runs non-mixed on the accelerator, and the data-side
    recovery on the CPU and for the mixed float64 finder — the JAX
    package's autos, unchanged until measured on Hopper."""
    if gram_projection not in ("auto", "data", "gram"):
        raise ValueError(f"unknown gram projection {gram_projection!r}")
    if gram_projection == "gram":
        if range_finder != "gram":
            raise ValueError(
                "gram_projection='gram' requires range_finder='gram'"
            )
        if mixed:
            raise ValueError(
                "gram_projection='gram' cannot honor the mixed f64 "
                "finder's 1e-10 sigma contract (sigma would be capped "
                "at the f32 Gram grade); use gram_projection='data'"
            )
        return "gram"
    if gram_projection == "data":
        return "data"
    if range_finder == "gram" and not mixed and device_type != "cpu":
        return "gram"
    return "data"


# Mean-cancellation guard thresholds per Gram precision: the fused
# uncentered Gram subtracts n·μμᵀ, losing ~(1 + r) of its input grade
# where r = n‖μ‖²/tr(Gc); beyond these ratios the subspace operator is
# recomputed from an explicitly centered copy.
_GRAM_GUARD_RMAX = {"default": 2.0, "high": 1e3, "highest": 1e5}


def _gram_of(xc, precision: str):
    """``XᵀX`` for the Gram finder.  Every ``precision`` grade is IEEE
    float32 here (float64 data stays float64)."""
    if precision not in _GRAM_GUARD_RMAX:
        raise ValueError(f"unknown gram precision {precision!r}")
    with ieee_f32():
        return xc.mT @ xc


def _gram_moments(x, centering: bool, fuse_centering: bool,
                  gram_precision: str, n: int):
    """``(means, G_centered, total_variance)`` for the Gram range finder.

    With fused centering the centered Gram is ``XᵀX − n·μμᵀ``, which
    loses ~(1 + r) of the Gram's input grade at r = n‖μ‖²/tr(Gc); past
    the per-precision threshold it is recomputed from an explicitly
    centered copy.
    """
    if not fuse_centering:
        means, xc = _masked_center(x, centering)
        return means, _gram_of(xc, gram_precision), (xc * xc).sum()
    if centering:
        means = x.sum(0) / n
    else:
        means = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    tv = centered_sqnorm_guarded(x, means, n)
    g_sub = _gram_of(x, gram_precision) - n * torch.outer(means, means)
    if centering:
        r = n * (means * means).sum() / torch.clamp(
            torch.diagonal(g_sub).sum(), min=1e-30
        )
        if float(r) > _GRAM_GUARD_RMAX[gram_precision]:
            g_sub = _gram_of(x - means, gram_precision)
    return means, g_sub, tv


def _fused_gram_flow(x, omega, centering: bool, n_power_iters: int,
                     gram_precision: str, n: int):
    """Gram range finder with the fused sketch+moments kernel (K1):
    ``(means, total_variance, Y)``.

    The subspace iteration runs on the RAW Gram ``XᵀX``, so the means
    are not needed before the sketch and ride the sketch pass inside the
    kernel.  ``XᵀX = XcᵀXc + n·μμᵀ`` is a rank-1 perturbation, and the
    appended ones column restores exact coverage of the centering
    correction — ``span{X·W, 1} ⊇ span{(X − 1μᵀ)·W}`` for any μ.  Past
    the mean-domination threshold the operator, subspace and sketch are
    redone from an explicitly centered copy.
    """
    g_raw = _gram_of(x, gram_precision)
    w = _gram_subspace(g_raw, omega, n_power_iters)
    y_raw, colsum, sq = sketch_kernel.fused_sketch_moments(
        x, w.contiguous()
    )
    if not centering:
        means = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
        return means, sq, y_raw
    means = colsum / n
    msq = n * (means * means).sum()
    # ‖X − 1μᵀ‖²_F = ‖X‖²_F − n‖μ‖², cancellation-guarded: tv is
    # user-visible (explained-variance denominators).
    tv = guarded_sqnorm_from(sq, means, n, x)
    ones_col = torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)
    r = msq / torch.clamp(tv, min=1e-30)
    if float(r) > _GRAM_GUARD_RMAX[gram_precision]:
        xc = x - means
        w_e = _gram_subspace(_gram_of(xc, gram_precision), omega,
                             n_power_iters)
        return means, tv, torch.cat([mdot(xc, w_e), ones_col], dim=1)
    corr = mdot(means[None, :], w)[0]
    return means, tv, torch.cat([y_raw - corr[None, :], ones_col], dim=1)


def randomized_pca_fit(x, omega, *, n_components: int, centering: bool = True,
                       n_oversamples: int = 10, n_power_iters: int = 7,
                       normalizer: str = "cholqr2",
                       fuse_centering: bool = True,
                       final_orth: str = "auto",
                       finder_precision: str = "full",
                       range_finder: str = "direct",
                       gram_precision: str = "auto",
                       gram_projection: str = "auto",
                       fused_sketch: bool = False):
    """Halko randomized SVD (pca.rs:665-718) on one device.

    The JAX function's contract, with the Gaussian test matrix ``omega``
    (d × l at ``x``'s dtype, l = min(k + n_oversamples, n, d)) passed in
    instead of a PRNG key, so callers and tests control it.  Returns
    ``{"u", "sigma", "vt", "means", "total_variance", "off"}``.

    Knobs (see the JAX function for the measured reasoning):

    * ``finder_precision`` — ``"full"``, ``"f32"`` (range finder of
      float64 data in float32; projection and SVD stay float64; complex
      data ignores it, as casting would drop the imaginary half) or
      ``"auto"`` (``"f32"`` for float64 on the accelerator).
    * ``range_finder`` — ``"direct"`` (2q+1 streaming passes), ``"gram"``
      (one Gram pass, the subspace iteration on the d×d operator, one
      sketch pass) or ``"auto"``.
    * ``gram_projection`` — Gram finder only: ``"data"`` (project
      B = QᵀX against the data), ``"gram"`` (zero-pass l×l recovery) or
      ``"auto"``.
    * ``fused_sketch`` — allow K1 on the data-side Gram route (real
      float32, ``gram_precision="default"``, within ``supports()``).
    * ``gram_precision`` — ``"default"``, ``"high"``, ``"highest"``
      (all IEEE float32 here; they still select the guard threshold) or
      ``"auto"`` (``"highest"`` for the mixed finder, else
      ``"default"``).
    """
    n, d = x.shape
    dev = x.device.type
    l = min(n_components + n_oversamples, n, d)
    if tuple(omega.shape) != (d, l):
        raise ValueError(f"omega must be {(d, l)}, got {tuple(omega.shape)}")
    if finder_precision not in ("auto", "f32", "full"):
        raise ValueError(f"unknown finder precision {finder_precision!r}")
    if finder_precision == "auto":
        finder_precision = (
            "f32" if x.dtype == torch.float64 and dev != "cpu" else "full"
        )
    mixed = finder_precision == "f32" and x.dtype == torch.float64
    if gram_projection == "gram" and range_finder == "auto":
        range_finder = "gram"
    range_finder = _resolve_range_finder(
        range_finder, n, d, l, dev,
        full_f64=x.dtype == torch.float64 and not mixed,
        is_complex=x.is_complex(),
    )
    if gram_precision == "auto":
        gram_precision = "highest" if mixed else "default"
    if gram_precision not in _GRAM_GUARD_RMAX:
        raise ValueError(f"unknown gram precision {gram_precision!r}")
    gram_projection = _resolve_gram_projection(
        gram_projection, range_finder, mixed, dev
    )
    if range_finder == "gram" and gram_projection == "gram":
        # Zero-pass recovery: the whole randomized SVD runs on Gc's l×l
        # algebra, then one fused centered matmul recovers the thin U
        # (needed for the reference-exact U-based svd_flip and for
        # fit_transform).
        means, g_sub, tv = _gram_moments(
            x, centering, fuse_centering, gram_precision, n
        )
        sigma, vt, off = randomized_gram_recovery(
            g_sub, omega, n_power_iters=n_power_iters
        )
        inv_sigma = torch.where(
            sigma > 0, 1.0 / torch.where(sigma > 0, sigma, 1.0), 0.0
        )
        # U = Xc·V·Σ⁻¹ (zero columns where σ was cut to 0).
        u = centered_matmul(x, vt.mH * inv_sigma[None, :], means)
        u, vt = svd_flip(u, vt)
        return {"u": u, "sigma": sigma, "vt": vt, "means": means,
                "total_variance": tv, "off": off}
    if normalizer not in ("lu", "qr", "cholqr2", "none"):
        raise ValueError(f"unknown normalizer {normalizer!r}")

    def norm(m):
        if normalizer == "lu":
            return lu_pl(m)
        if normalizer == "qr":
            return torch.linalg.qr(m, mode="reduced").Q
        if normalizer == "cholqr2":
            return cholesky_qr2(m)
        return m

    gram_means = range_finder == "gram" and not mixed
    if not gram_means:
        # The Gram routes take the means from their own pass over X; an
        # eager port must not spend a column-sum pass they would discard.
        means, xm, xtm, _, sqnorm = _contractions(
            x, centering, fuse_centering
        )
    if mixed:
        f32 = torch.float32
        # One pass: the centered float32 copy the finder iterates on.
        xc32 = x.to(f32) - means.to(f32) if centering else x.to(f32)
        if range_finder == "gram":
            g_sub = _gram_of(xc32, gram_precision)
            w = _gram_subspace(g_sub, omega.to(f32), n_power_iters)
            q = mdot(xc32, w)
        else:
            q = mdot(xc32, omega.to(f32))
            for _ in range(n_power_iters):
                q = mdot(xc32.mH, norm(q))
                q = mdot(xc32, norm(q))
        q = q.to(x.dtype)
    elif range_finder == "gram":
        use_fused = (
            fused_sketch
            and fuse_centering
            and gram_precision == "default"
            and x.dtype == torch.float32
            and sketch_kernel.supports(n, d, l, x.dtype)
        )
        if use_fused:
            means, tv, q = _fused_gram_flow(
                x, omega, centering, n_power_iters, gram_precision, n
            )
        else:
            means, g_sub, tv = _gram_moments(
                x, centering, fuse_centering, gram_precision, n
            )
            w = _gram_subspace(g_sub, omega, n_power_iters)
            q = centered_matmul(x, w, means)
    else:
        q = xm(omega)
        for _ in range(n_power_iters):
            q = xtm(norm(q))
            q = xm(norm(q))
    # Final orthonormalization: Householder QR matches the reference's
    # economy-QR semantics (linalg.rs:127-147); CholeskyQR2 is the
    # matmul-only choice.  Always at the data dtype.
    if final_orth == "auto":
        final_orth = "qr" if normalizer == "qr" else "cholqr2"
    if final_orth not in ("qr", "cholqr2"):
        raise ValueError(f"unknown final_orth {final_orth!r}")
    q = torch.linalg.qr(q, mode="reduced").Q if final_orth == "qr" else (
        cholesky_qr2(q)
    )
    if gram_means:
        # Qᵀ(X − 1μᵀ) with the Gram branch's means (the fused kernel's
        # column sums), formed (l, d) row-major: the SVD's transpose then
        # hands B's rows to K2 as the columns it rotates, with no copy.
        # Real data only: the Gram finder rejects complex.
        b = mdot(q.mT, x) - torch.outer(q.sum(0), means)
    else:
        b = xtm(q).mH  # (l, d): Qᴴ·Xc
    u_b, sigma, vt, off = svd_jit_cert(b)
    if q.shape[1] > l:
        # The fused route widened Q with the ones (centering) column; its
        # singular direction is ~0 and sorts last.  Drop it so every
        # route installs identically-shaped state.
        u_b, sigma, vt = u_b[:, :l], sigma[:l], vt[:l]
    u = mdot(q, u_b)
    u, vt = svd_flip(u, vt)
    return {
        "u": u,
        "sigma": sigma,
        "vt": vt,
        "means": means,
        "total_variance": tv if gram_means else sqnorm(),
        "off": off,
    }
