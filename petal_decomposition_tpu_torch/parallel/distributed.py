"""Row-sharded fit pipelines — the counterpart of
``petal_decomposition_tpu/parallel/distributed.py``: the exact Gram
solver ``pca_fit_gram``, the Halko ``randomized_pca_fit`` and
``fast_ica_fit``.

Each pipeline takes one tensor (one device) or the row shards of a mesh
(:class:`.mesh.Rows`).  Where the JAX package writes the fit once and
GSPMD turns every sample-axis contraction into a local product plus a
``psum``, this port makes the sum explicit: each shard computes its
partial product, :func:`psum` adds the local shards in mesh order on the
first device and then all-reduces over the process group.  The small
factorizations (the d×d eigh, the l×d SVD, FastICA's k×k
decorrelation) run on each process's first device on the reduced
operands, which every process holds bitwise equal, so they give the same
state everywhere; on the card they are K2 and K3.  A tensor without a
mesh is one shard with no collective, and runs the single-device fit
unchanged.

Mean-centering is fused as a rank-1 correction into every contraction
(:mod:`..ops.centered`).  ``n_valid`` marks zero-padded rows (uneven
sharding): means divide by the true count and every X·M product is
re-zeroed on padded rows.  Reductions run in another order than XLA's
psum, so a sharded fit agrees with the JAX package's to a relative band
(1e-10 float64, 1e-5 float32), not bitwise.  The JAX package's in-graph
``lax.cond`` guards become host-side branches on one scalar each.  The
Gram and its grade's rules are :mod:`..ops.gram`'s.
"""

from __future__ import annotations

import math

import torch

from ..ops import gram as _gram
from ..ops.centered import (
    _SQNORM_GUARD_RMAX,
    abs2,
    centered_matmul,
    centered_rmatmul,
    guarded_sqnorm_from,
    mask_rows,
)
from ..ops.gram_recovery import (
    gram_subspace as _gram_subspace,
    randomized_gram_recovery,
)
from ..ops.kernels import sketch_kernel
from ..ops.linalg import (
    cholesky_qr2,
    cholqr_right_factor,
    eigh_psd_jit_cert,
    flip_signs,
    lu_pl,
    mdot,
    svd_flip,
    svd_jit_cert,
)
from ..utils.profiling import span
from .mesh import Columns, Rows

__all__ = [
    "pca_fit_gram",
    "randomized_pca_fit",
    "fast_ica_fit",
    "psum",
    "all_gather",
    "collectives",
]


# -- collectives -----------------------------------------------------


class CollectiveStats:
    """What this process's collectives moved: ``calls`` and ``bytes``
    (each call's tensor as this process sends it)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0


collectives = CollectiveStats()


def _counted(t: torch.Tensor, name: str, run) -> None:
    """``run()``, the collective, counted and inside the span ``name``,
    under which its kernels (NCCL's) fall."""
    collectives.calls += 1
    collectives.bytes += t.numel() * t.element_size()
    with span(name):
        run()


def _all_reduce(t: torch.Tensor, mesh) -> None:
    """In-place sum over the mesh's processes.  Under gloo a card tensor
    goes through gloo's own CUDA path (staged through host memory by
    gloo itself)."""
    import torch.distributed as dist

    _counted(t, "petal.mesh.all_reduce",
             lambda: dist.all_reduce(t, group=mesh.group))


def psum(parts, mesh) -> torch.Tensor:
    """The JAX ``psum`` of per-shard partial results ``parts`` (this
    process's shards, in mesh order): their sum on the mesh's first
    device, added in mesh order, then all-reduced over the process group
    (also a group of one).  Every process gets the same bits.  Without a
    mesh, the one part itself.  The parts are consumed."""
    if mesh is None:
        (only,) = parts
        return only
    lead = mesh.lead
    acc = parts[0].to(lead)
    for p in parts[1:]:
        acc = acc + p.to(lead)
    if mesh.group is not None:
        _all_reduce(acc, mesh)
    return acc


def all_gather(t: torch.Tensor, mesh) -> torch.Tensor:
    """``(world, *t.shape)``: every process's ``t``, in process order, on
    ``t``'s device.  Under NCCL on the mesh's card; under gloo through
    host memory (a card tensor is staged through it), the one collective
    of the port that takes gloo's CPU path."""
    import torch.distributed as dist

    backend = dist.get_backend(mesh.group)
    comm = t.to(mesh.lead) if backend == "nccl" else t.cpu()
    comm = comm.contiguous()
    out = torch.empty((mesh.world,) + tuple(comm.shape), dtype=comm.dtype,
                      device=comm.device)
    if backend == "nccl":
        _counted(comm, "petal.mesh.all_gather",
                 lambda: dist.all_gather_into_tensor(out, comm,
                                                     group=mesh.group))
    else:
        _counted(comm, "petal.mesh.all_gather",
                 lambda: dist.all_gather(list(out.unbind(0)), comm,
                                         group=mesh.group))
    return out.to(t.device)


def as_rows(x, n_valid: int | None = None) -> Rows:
    """``x`` as row shards: a :class:`.mesh.Rows` as it is, a tensor as
    one shard whose first ``n_valid`` rows are data."""
    return x if isinstance(x, Rows) else Rows.single(x, n_valid)


def _out(rows: Rows, like):
    """A per-row result in the form of the input: the shards for sharded
    input, the tensor for a tensor."""
    return rows if isinstance(like, Rows) else rows.shards[0]


def _reduce(xs: Rows, fn, *replicated) -> torch.Tensor:
    """:func:`psum` of ``fn(shard, valid, *replicated)`` over the shards."""
    return psum([fn(s, v, *reps) for s, v, reps in
                 zip(xs.shards, xs.valid, xs.on_devices(*replicated))],
                xs.mesh)


def svd_flip_rows(u: Rows, vt: torch.Tensor):
    """``svd_flip`` with a row-sharded U: each column's pivot is its
    first entry of largest magnitude across all shards in row order (the
    reference's scan), found from each shard's own pivot."""
    if u.mesh is None:
        uf, vtf = svd_flip(u.shards[0], vt)
        return Rows.single(uf, u.n_valid), vtf
    k = min(u.shape[1], vt.shape[0])
    stats = []
    for s in u.shards:
        cols = s[:, :k]
        if cols.shape[0] == 0:
            mag = torch.full((k,), -1.0, dtype=cols.real.dtype,
                             device=cols.device)
            piv = torch.zeros((k,), dtype=cols.dtype, device=cols.device)
        else:
            mag = cols.abs().amax(0)
            idx = torch.argmax(cols.abs(), dim=0)  # first max
            piv = torch.gather(cols, 0, idx[None, :])[0]
        stats.append(torch.stack([mag.to(piv.dtype), piv]).to(u.mesh.lead))
    local = torch.stack(stats)  # (local shards, 2, k)
    if u.mesh.spans_processes:
        local = all_gather(local, u.mesh).flatten(0, 1)
    mags, pivs = local[:, 0].real, local[:, 1]
    first = torch.argmax((mags == mags.amax(0)).to(torch.int32), dim=0)
    signs = flip_signs(torch.gather(pivs, 0, first[None, :])[0])

    def flip(s, _v, sg):
        s = s.clone()
        s[:, :k] *= sg[None, :]
        return s

    vt = vt.clone()
    vt[:k, :] *= signs[:, None]
    return u.map(flip, signs), vt


# -- contractions over the shards --------------------------------------


def _means(xs: Rows, centering: bool) -> torch.Tensor:
    """Column means over the data rows (padded rows are zero), or zeros
    when centering is off."""
    if centering:
        return _reduce(xs, lambda s, v: s.sum(0)) / xs.n_valid
    return torch.zeros(xs.shape[1], dtype=xs.dtype, device=xs.device)


def _masked_center(xs: Rows, centering: bool):
    """Explicit (non-fused) centering with padded rows re-zeroed:
    ``(means, X − 1μᵀ)``."""
    means = _means(xs, centering)
    if not centering:
        return means, xs
    return means, xs.map(lambda s, v, mu: mask_rows(s - mu, v), means)


def _sqnorm(s: torch.Tensor) -> torch.Tensor:
    """``‖s‖²_F`` by one fused reduction: no temporary the size of ``s``
    (``abs2(s).sum()`` writes and reads one)."""
    return torch.linalg.vector_norm(s).square()


def _centered_sqnorm(xs: Rows, means, n: int):
    """``‖X − 1μᵀ‖²_F`` with the mean-domination guard, reduced over
    the shards."""
    return guarded_sqnorm_from(
        _reduce(xs, lambda s, v: _sqnorm(s)), means, n,
        lambda: _reduce(xs, lambda s, v, mu: abs2(mask_rows(s - mu, v)).sum(),
                        means),
    )


def _contractions(xs: Rows, centering: bool, fuse_centering: bool):
    """Returns ``(means, xm, xtm, gram, sqnorm)`` closures over the
    centered data, fused or explicit.  ``xm`` gives row shards, the rest
    reduced operands; ``gram`` is the conjugate Gram ``XcᴴXc``
    (``XᴴX − n·μ̄μᵀ`` fused)."""
    n = xs.n_valid
    if fuse_centering:
        means = _means(xs, centering)
        return (
            means,
            lambda m: xs.map(_centered_matmul, m, means),
            lambda q: psum([
                centered_rmatmul(s, qs, mu) for s, qs, (mu,) in
                zip(xs.shards, q.shards, xs.on_devices(means))
            ], xs.mesh),
            lambda: _reduce(xs, lambda s, v: mdot(s.mH, s))
            - n * torch.outer(means.conj(), means),
            lambda: _centered_sqnorm(xs, means, n),
        )
    means, xc = _masked_center(xs, centering)
    return (
        means,
        lambda m: xc.map(lambda s, v, mm: mdot(s, mm), m),
        lambda q: psum([mdot(s.mH, qs) for s, qs in
                        zip(xc.shards, q.shards)], xs.mesh),
        lambda: _reduce(xc, lambda s, v: mdot(s.mH, s)),
        lambda: _reduce(xc, lambda s, v: abs2(s).sum()),
    )


def _centered_matmul(s, valid, m, means):
    """:func:`..ops.centered.centered_matmul` on one shard."""
    return centered_matmul(s, m, means, valid)


def _scale_cols(rows: Rows, scale) -> Rows:
    return rows.map(lambda s, v, sc: s * sc[None, :], scale)


def pca_fit_gram(x, *, centering: bool = True, n_valid: int | None = None,
                 fuse_centering: bool = True):
    """Exact PCA via the covariance eigenproblem (``distributed.py:
    114-177``): ``C = XcᴴXc`` (one reduction), ``eigh(C)`` replicated,
    thin ``U = Xc·V·σ⁻¹`` on the shards.

    Returns the same fields as the SVD path — ``{"u", "sigma", "vt",
    "means", "total_variance", "off"}`` with k = min(n, d) — U/σ/Vᴴ
    reproduce the full-SVD factorization including the deterministic
    ``svd_flip`` signs.  ``u`` is row shards for sharded input.  ``off``
    is the eigensolve's certificate (K3's on CUDA at float64), which the
    caller checks.
    """
    xs = as_rows(x, n_valid)
    n, d = xs.n_valid, xs.shape[1]
    means, xm, _, gram, _ = _contractions(xs, centering, fuse_centering)
    c = gram()
    if fuse_centering and centering:
        # σ come straight from this Gram: the fused rank-1 centering
        # loses ~(1 + r) of the input grade at r = n‖μ‖²/tr(C), so the
        # exact path uses the tight thresholds of the total-variance
        # guard; past them it rebuilds C from an explicitly centered
        # copy (one host read of r decides).
        tr = torch.diagonal(c).real.sum()
        r = n * (means.abs() ** 2).sum() / torch.clamp(tr, min=1e-30)
        if float(r) > _SQNORM_GUARD_RMAX[tr.dtype]:
            c = _reduce(_masked_center(xs, True)[1],
                        lambda s, v: mdot(s.mH, s))
    lam, v, off = eigh_psd_jit_cert(c)  # ascending
    lam = lam.flip(0)
    v = v.flip(1)
    sigma = torch.sqrt(torch.clamp(lam, min=0))
    inv_sigma = torch.where(
        sigma > 0, 1.0 / torch.where(sigma > 0, sigma, 1.0), 0.0
    )
    u = _scale_cols(xm(v), inv_sigma.to(xs.dtype))
    u, vt = svd_flip_rows(u, v.mH)
    k_full = min(n, d)
    return {
        "u": _out(u.map(lambda s, _v: s[:, :k_full]), x),
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


def _gram_moments(xs: Rows, centering: bool, fuse_centering: bool,
                  gram_precision: str, n: int):
    """``(means, G_centered, total_variance)`` for the Gram range finder.

    With fused centering the centered Gram is ``XᵀX − n·μμᵀ``, which
    loses ~(1 + r) of the Gram's input grade at r = n‖μ‖²/tr(Gc); past
    the grade's :func:`..ops.gram.guard_rmax` it is recomputed from an
    explicitly centered copy.
    """
    if not fuse_centering:
        means, xc = _masked_center(xs, centering)
        return (means,
                _reduce(xc, lambda s, v: _gram.gram(s)),
                _reduce(xc, lambda s, v: (s * s).sum()))
    means = _means(xs, centering)
    tv = _centered_sqnorm(xs, means, n)
    g_sub = (_reduce(xs, lambda s, v: _gram.gram(s))
             - n * torch.outer(means, means))
    if centering:
        r = n * (means * means).sum() / torch.clamp(
            torch.diagonal(g_sub).sum(), min=1e-30
        )
        if float(r) > _gram.guard_rmax(gram_precision):
            g_sub = _reduce(
                xs, lambda s, v, mu: _gram.gram(mask_rows(s - mu, v)), means)
    return means, g_sub, tv


def _fused_gram_flow(xs: Rows, omega, centering: bool, n_power_iters: int,
                     gram_precision: str, n: int):
    """Gram range finder with the fused sketch+moments kernel (K1), on
    each shard: ``(means, total_variance, Y)``.

    The subspace iteration runs on the RAW Gram ``XᵀX``, so the means
    are not needed before the sketch and ride the sketch pass inside the
    kernel.  ``XᵀX = XcᵀXc + n·μμᵀ`` is a rank-1 perturbation, and the
    appended ones column restores exact coverage of the centering
    correction — ``span{X·W, 1} ⊇ span{(X − 1μᵀ)·W}`` for any μ.  Zero
    padded rows add nothing to K1's outputs; the ones column and the
    centering correction are masked there.  Past the mean-domination
    threshold the operator, subspace and sketch are redone from an
    explicitly centered copy.
    """
    g_raw = _reduce(xs, lambda s, v: _gram.gram(s))
    w = _gram_subspace(g_raw, omega, n_power_iters)
    y_raw, colsum, sq = sketch_kernel.fused_sketch_moments_on(
        xs, w.contiguous())
    if not centering:
        means = torch.zeros(xs.shape[1], dtype=xs.dtype, device=xs.device)
        return means, sq, y_raw

    def ones_col(s, v):
        return mask_rows(torch.ones((s.shape[0], 1), dtype=s.dtype,
                                    device=s.device), v)

    means = colsum / n
    msq = n * (means * means).sum()
    # ‖X − 1μᵀ‖²_F = ‖X‖²_F − n‖μ‖², cancellation-guarded: tv is
    # user-visible (explained-variance denominators).
    tv = guarded_sqnorm_from(
        sq, means, n,
        lambda: _reduce(xs, lambda s, v, mu: abs2(mask_rows(s - mu, v)).sum(),
                        means),
    )
    r = msq / torch.clamp(tv, min=1e-30)
    if float(r) > _gram.guard_rmax(gram_precision):
        xc = xs.map(lambda s, v, mu: mask_rows(s - mu, v), means)
        w_e = _gram_subspace(_reduce(xc, lambda s, v: _gram.gram(s)), omega,
                             n_power_iters)
        return means, tv, xc.map(
            lambda s, v, we: torch.cat([mdot(s, we), ones_col(s, v)], dim=1),
            w_e)
    corr = mdot(means[None, :], w)[0]
    return means, tv, y_raw.map(
        lambda y, v, c: torch.cat([mask_rows(y - c[None, :], v),
                                   ones_col(y, v)], dim=1),
        corr)


def _gathered(q: Rows, fn) -> Rows:
    """``fn`` on the whole of a row-sharded panel: gathered, applied on
    the first device, and split back into the shard layout (for the
    factorizations of a panel that are not sums over its rows)."""
    if q.mesh is None:
        return Rows.single(fn(q.shards[0]), q.n_valid)
    return q.like(fn(q.full()))


def _cholesky_qr2(q: Rows) -> Rows:
    """CholeskyQR2 of a row-sharded panel: each round's Gram is one
    reduction, the factor applied to every shard."""
    for _ in range(2):
        right = cholqr_right_factor(_reduce(q, lambda s, v: mdot(s.mH, s)))
        q = q.map(lambda s, v, f: mdot(s, f), right)
    return q


def _normalize(m, normalizer: str):
    """The power iteration's normalizer on a row-sharded panel or a
    replicated d×l one."""
    if normalizer == "none":
        return m
    if not isinstance(m, Rows):
        if normalizer == "lu":
            return lu_pl(m)
        if normalizer == "qr":
            return torch.linalg.qr(m, mode="reduced").Q
        return cholesky_qr2(m)
    if normalizer == "cholqr2":
        return _cholesky_qr2(m)
    if normalizer == "lu":
        return _gathered(m, lu_pl)
    return _gathered(m, lambda a: torch.linalg.qr(a, mode="reduced").Q)


def randomized_pca_fit(x, omega, *, n_components: int, centering: bool = True,
                       n_oversamples: int = 10, n_power_iters: int = 7,
                       normalizer: str = "cholqr2",
                       n_valid: int | None = None,
                       fuse_centering: bool = True,
                       final_orth: str = "auto",
                       finder_precision: str = "full",
                       range_finder: str = "direct",
                       gram_precision: str = "auto",
                       gram_projection: str = "auto",
                       fused_sketch: bool = False):
    """Halko randomized SVD (pca.rs:665-718) on one tensor or on the row
    shards of a mesh.

    The JAX function's contract, with the Gaussian test matrix ``omega``
    (d × l at ``x``'s dtype, l = min(k + n_oversamples, n, d)) passed in
    instead of a PRNG key, so callers and tests control it.  Returns
    ``{"u", "sigma", "vt", "means", "total_variance", "off"}``; ``u`` is
    row shards for sharded input.  On a mesh each power iteration costs
    two reductions of (d × l) and (l × l) panels; the panel's LU and QR
    normalizers, which are not sums over its rows, gather it.

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
      float32, fused centering, a grade K1 may sketch at, within
      ``supports()`` at the rows of one shard); on a mesh K1 runs on
      every shard.
    * ``gram_precision`` — ``"auto"``, ``"default"``, ``"high"`` or
      ``"highest"``: :mod:`..ops.gram` resolves it and holds its rules.
    """
    xs = as_rows(x, n_valid)
    n, d = xs.n_valid, xs.shape[1]
    dev = xs.device.type
    l = min(n_components + n_oversamples, n, d)
    if tuple(omega.shape) != (d, l):
        raise ValueError(f"omega must be {(d, l)}, got {tuple(omega.shape)}")
    if finder_precision not in ("auto", "f32", "full"):
        raise ValueError(f"unknown finder precision {finder_precision!r}")
    if finder_precision == "auto":
        finder_precision = (
            "f32" if xs.dtype == torch.float64 and dev != "cpu" else "full"
        )
    mixed = finder_precision == "f32" and xs.dtype == torch.float64
    if gram_projection == "gram" and range_finder == "auto":
        range_finder = "gram"
    range_finder = _resolve_range_finder(
        range_finder, n, d, l, dev,
        full_f64=xs.dtype == torch.float64 and not mixed,
        is_complex=xs.is_complex(),
    )
    gram_precision = _gram.resolve(gram_precision, xs.dtype, dev,
                                   mixed=mixed)
    gram_projection = _resolve_gram_projection(
        gram_projection, range_finder, mixed, dev
    )
    if range_finder == "gram" and gram_projection == "gram":
        # Zero-pass recovery: the whole randomized SVD runs on Gc's l×l
        # algebra, then one fused centered matmul recovers the thin U
        # (needed for the reference-exact U-based svd_flip and for
        # fit_transform).
        with span("petal.rpca.moments"):
            means, g_sub, tv = _gram_moments(
                xs, centering, fuse_centering, gram_precision, n
            )
        with span("petal.rpca.gram_recovery"):
            sigma, vt, off = randomized_gram_recovery(
                g_sub, omega, n_power_iters=n_power_iters
            )
        with span("petal.rpca.recover_u"):
            inv_sigma = torch.where(
                sigma > 0, 1.0 / torch.where(sigma > 0, sigma, 1.0), 0.0
            )
            # U = Xc·V·Σ⁻¹ (zero columns where σ was cut to 0).
            u = xs.map(_centered_matmul, vt.mH * inv_sigma[None, :], means)
        with span("petal.rpca.svd_flip"):
            u, vt = svd_flip_rows(u, vt)
        return {"u": _out(u, x), "sigma": sigma, "vt": vt, "means": means,
                "total_variance": tv, "off": off}
    if normalizer not in ("lu", "qr", "cholqr2", "none"):
        raise ValueError(f"unknown normalizer {normalizer!r}")

    def norm(m):
        return _normalize(m, normalizer)

    gram_means = range_finder == "gram" and not mixed
    if not gram_means:
        # The Gram routes take the means from their own pass over X; an
        # eager port must not spend a column-sum pass they would discard.
        means, xm, xtm, _, sqnorm = _contractions(
            xs, centering, fuse_centering
        )
    with span("petal.rpca.sketch"):
        if mixed:
            f32 = torch.float32
            # One pass: the centered float32 copy the finder iterates on.
            xc32 = xs.map(
                lambda s, v, mu: mask_rows(s.to(f32) - mu if centering
                                           else s.to(f32), v),
                means.to(f32))
            if range_finder == "gram":
                g_sub = _reduce(xc32, lambda s, v: _gram.gram(s))
                w = _gram_subspace(g_sub, omega.to(f32), n_power_iters)
                q = xc32.map(lambda s, v, ww: mdot(s, ww), w)
            else:
                q = xc32.map(lambda s, v, om: mdot(s, om), omega.to(f32))
                for _ in range(n_power_iters):
                    qn = norm(q)
                    q = psum([mdot(s.mH, qs) for s, qs in
                              zip(xc32.shards, qn.shards)], xs.mesh)
                    q = xc32.map(lambda s, v, m: mdot(s, m), norm(q))
            q = q.map(lambda s, v: s.to(xs.dtype))
        elif range_finder == "gram":
            use_fused = (
                fused_sketch
                and fuse_centering
                and _gram.k1_allowed(gram_precision)
                and xs.dtype == torch.float32
                and sketch_kernel.supports(xs.rows_per_shard, d, l, xs.dtype)
            )
            if use_fused:
                means, tv, q = _fused_gram_flow(
                    xs, omega, centering, n_power_iters, gram_precision, n
                )
            else:
                with span("petal.rpca.moments"):
                    means, g_sub, tv = _gram_moments(
                        xs, centering, fuse_centering, gram_precision, n
                    )
                w = _gram_subspace(g_sub, omega, n_power_iters)
                q = xs.map(_centered_matmul, w, means)
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
    with span("petal.rpca.orthonormalize"):
        q = _normalize(q, final_orth)
    with span("petal.rpca.project"):
        if gram_means:
            # Qᵀ(X − 1μᵀ) with the Gram branch's means (the fused kernel's
            # column sums), formed (l, d) row-major: the SVD's transpose
            # then hands B's rows to K2 as the columns it rotates, with no
            # copy.  Real data only: the Gram finder rejects complex.
            b = (psum([mdot(qs.mT, s) for qs, s in zip(q.shards,
                                                        xs.shards)],
                      xs.mesh)
                 - torch.outer(_reduce(q, lambda s, v: s.sum(0)), means))
        else:
            b = xtm(q).mH  # (l, d): Qᴴ·Xc
    with span("petal.rpca.svd_b"):
        u_b, sigma, vt, off = svd_jit_cert(b)
    if q.shape[1] > l:
        # The fused route widened Q with the ones (centering) column; its
        # singular direction is ~0 and sorts last.  Drop it so every
        # route installs identically-shaped state.
        u_b, sigma, vt = u_b[:, :l], sigma[:l], vt[:l]
    with span("petal.rpca.recover_u"):
        u = q.map(lambda s, v, ub: mdot(s, ub), u_b)
    with span("petal.rpca.svd_flip"):
        u, vt = svd_flip_rows(u, vt)
    return {
        "u": _out(u, x),
        "sigma": sigma,
        "vt": vt,
        "means": means,
        "total_variance": tv if gram_means else sqnorm(),
        "off": off,
    }


def fast_ica_fit(x, w_init, *, fun: str = "logcosh", tol: float = 1e-4,
                 max_iter: int = 200, n_valid: int | None = None,
                 fuse_centering: bool = True,
                 n_components: int | None = None, whiten: bool = True,
                 decorrelation: str = "eigh", precision: str = "full"):
    """FastICA with Gram/eigh whitening on one tensor or on the row
    shards of a mesh (``distributed.py:720-808``).

    Whitening reduces over the samples once (the d×d Gram) and solves
    the replicated eigenproblem; every ``ica_par`` step reduces the
    k×k product against Gᵀ and the k g′ sums over the shards (one
    reduction), then decorrelates the replicated k×k update.  ``w_init``
    is the Gaussian W₀, (k, k) with k = min(n_components, n, d), or
    (d, d) under ``whiten=False``, where the caller certifies centered,
    whitened data: ``ica_par`` runs on Xᵀ as it is and ``components`` is
    the square unmixing W.

    Returns ``{"components", "means", "n_iter", "lim", "off",
    "w_orth_err"}``; ``off`` is the whitening eigensolve's certificate,
    ``w_orth_err`` the decorrelation certificate.
    """
    from ..models._common import real_dtype
    from ..models.fast_ica import (
        _ica_par_core,
        _rounded,
        _whitening_from_spectrum,
        decorrelation_certificate,
    )

    xs = as_rows(x, n_valid)
    n, d = xs.n_valid, xs.shape[1]
    real = real_dtype(xs.dtype)
    tol = _rounded(tol, real)
    if not whiten:
        cols = Columns([s.mT for s in xs.shards], xs.mesh, xs.n_rows)
        w, lim, n_iter = _ica_par_core(
            cols.value(), tol, max_iter, w_init, fun, n_valid=n,
            decorrelation=decorrelation, precision=precision,
        )
        zero = torch.zeros((), dtype=real, device=xs.device)
        return {
            "components": w,
            "means": torch.zeros((d,), dtype=real, device=xs.device),
            "n_iter": n_iter,
            "lim": lim,
            "off": zero,
            "w_orth_err": decorrelation_certificate(w),
        }
    k = min(n, d) if n_components is None else min(n_components, n, d)
    means, xm, _, gram, _ = _contractions(xs, True, fuse_centering)
    lam, v, whiten_off = eigh_psd_jit_cert(gram())
    sigma = torch.sqrt(torch.clamp(lam.flip(0), min=0))
    u = v.flip(1)
    # The rank cutoff of models.fast_ica._whitening_matrix: degenerate
    # directions whiten to zero.
    kmat, _, inv_sigma = _whitening_from_spectrum(u, sigma, k, max(n, d))
    # X₁ = K·Xᵀ·√n, computed sharded-first: (Xc·V·σ⁻¹)ᵀ·√n, a k × n_s
    # column block on each shard.
    scale = math.sqrt(n)
    x1 = Columns([(y * scale).mT.contiguous() for y in
                  _scale_cols(xm(u[:, :k]), inv_sigma.to(xs.dtype)).shards],
                 xs.mesh, xs.n_rows)
    w, lim, n_iter = _ica_par_core(
        x1.value(), tol, max_iter, w_init, fun, n_valid=n,
        decorrelation=decorrelation, precision=precision,
    )
    return {
        "components": mdot(w, kmat),
        "means": means,
        "n_iter": n_iter,
        "lim": lim,
        "off": whiten_off,
        "w_orth_err": decorrelation_certificate(w),
    }
