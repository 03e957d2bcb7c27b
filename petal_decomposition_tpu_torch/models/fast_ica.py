"""Parallel (symmetric) FastICA — the counterpart of
``petal_decomposition_tpu/models/fast_ica.py`` (ref: ica.rs:41-398).

The same algorithm, knobs, autos and errors:

* ``n_components = min(n_samples, n_features)`` unless set (ica.rs:173);
* the whitening matrix K fills **all** feature columns —
  ``K = (U[:, :k] / σ[:k])ᵀ`` with numerically dead directions zeroed —
  which fixes the reference's uninitialised memory when n_features >
  n_samples (ica.rs:190-203);
* ``ica_par``'s convergence functional is the reference's
  ``max_i ||row_i(W1)·col_i(W)| − 1|`` (ica.rs:344-354), and
  ``n_iter == max_iter`` means the fit did not converge (ica.rs:360);
* contrasts ``logcosh`` (the reference's), ``exp`` and ``cube``.

On CUDA the float64 eigensolves (the Gram whitening, the first
decorrelation of the random W₀, the re-orthonormalization between the
``iteration_precision="f32"`` stages and every in-loop decorrelation
under ``decorrelation="eigh"``) run the hand-written K3 kernel through
``ops.linalg.eigh_psd_jit_cert``, and the float32 SVD whitening of a
tall panel runs Householder QR and K2 on R through ``ops.jacobi``.  The
two k×n products of a step are cuBLAS matmuls, as they are XLA ops in
the JAX package.  A float32 step under Newton–Schulz decorrelation runs
the rest of its update — the update formula, the decorrelation and the
stop value — as one launch of the hand-written K4
(``ops/kernels/ica_update.py``) where it takes W (:func:`_k4_takes`).

Where the JAX package runs the whole iteration as one on-device
``lax.while_loop``, this loop runs on the host: its stop test, ``(lim ≥
tol) & (it < budget)``, reads ``lim`` once a step.

``fit_batched`` and ``transform_batched`` stream row blocks in two
passes (:mod:`.streaming`).  On a mesh (``mesh=``, :mod:`..parallel.mesh`)
the fit is ``parallel.distributed.fast_ica_fit``: the Gram whitening
reduced over the row shards, each step's k×k products reduced over
their column blocks of X₁, the decorrelation replicated.

Not ported: ``key=`` and ``with_key`` (a JAX key cannot cross over; the
port seeds from ``seed``).
"""

from __future__ import annotations

import math

import torch

from ..config import config as _config
from ..errors import InvalidInput, LinalgError
from ..ops import linalg as _linalg
from ..ops import splitmm
from ..ops.kernels import ica_update
from ..ops.linalg import mdot
from ..parallel.mesh import Columns, Rows
from ..utils import rng as rng_util
from ..utils.profiling import span
from . import _common

__all__ = [
    "FastIca",
    "FastIcaBuilder",
    "ica_par",
    "symmetric_decorrelation",
    "symmetric_decorrelation_ns",
    "logcosh",
]

_CONTRASTS = ("logcosh", "exp", "cube")


def symmetric_decorrelation(w: torch.Tensor) -> torch.Tensor:
    """W ← (W·Wᴴ)^(−1/2)·W via eigendecomposition (ref: ica.rs:363-381).

    The Gram is the Hermitian ``W·Wᴴ`` (the reference forms ``W·Wᵀ``,
    which is the same for real W).  Eigenvalues λ ≤ λmax·eps·k invert to
    0 instead of inf: a pseudo-inverse for numerically dead directions.

    >>> w = torch.tensor([[33.0, 24.0], [48.0, 57.0]], dtype=torch.float64)
    >>> d = symmetric_decorrelation(w)
    >>> bool((d @ d.T - torch.eye(2, dtype=d.dtype)).abs().max() < 1e-12)
    True
    """
    e, v = _linalg.eigh_psd_jit(mdot(w, w.mH))
    cutoff = e[-1] * torch.finfo(e.dtype).eps * w.shape[0]
    ok = e > cutoff
    inv_sqrt = torch.where(ok, 1.0 / torch.sqrt(torch.where(ok, e, 1.0)), 0.0)
    return mdot(mdot(v * inv_sqrt.to(w.dtype)[None, :], v.mH), w)


def symmetric_decorrelation_ns(w: torch.Tensor, iters: int = 24):
    """The same ``(W·Wᴴ)^(−1/2)·W`` by coupled Newton–Schulz: ~3 k×k
    matmuls a step and no eigensolver.  Trace scaling puts the spectrum
    of A/c in (0, 1], where the iteration converges globally; 24 steps
    reach working precision for κ(A) ≲ 1e5."""
    # One IEEE-float32 scope for the ~3·iters small products (mdot
    # enters it once a product).
    with _linalg.ieee_f32():
        a = w @ w.mH
        k = a.shape[0]
        c = torch.trace(a).real  # ≥ λ_max for a PSD A
        y = a / c
        eye = torch.eye(k, dtype=a.dtype, device=a.device)
        z = eye
        for _ in range(iters):
            t = 1.5 * eye - 0.5 * (z @ y)
            y, z = y @ t, t @ z
        # z ≈ (A/c)^(−1/2), so A^(−1/2) = z/√c.
        return (z @ w) / torch.sqrt(c).to(w.dtype)


def _contrast_sums(fun: str, wx: torch.Tensor, sum_dtype=None):
    """G and the per-row *sum* of g′(wx) for the given contrast.
    ``sum_dtype`` widens the g′ row sum (the ds64 stage evaluates the
    contrast in float32 but carries its n-long reduction in float64)."""
    if fun == "logcosh":
        g = torch.tanh(wx)
        # 1 − g² in g²'s own buffer: one k×n temporary beside G, not two
        # (the same operations and roundings as ``1.0 - g * g``).
        gp = g * g
        torch.sub(torch.ones((), dtype=gp.dtype), gp, out=gp)
        s = gp.sum(1, dtype=sum_dtype)
    elif fun == "exp":
        e = torch.exp(-(wx * wx) / 2.0)
        g = wx * e
        s = ((1.0 - wx * wx) * e).sum(1, dtype=sum_dtype)
    elif fun == "cube":
        g = wx * wx * wx
        s = (3.0 * wx * wx).sum(1, dtype=sum_dtype)
    else:
        raise ValueError(f"unknown contrast function {fun!r}")
    return g, s


# g′(0) per contrast: padded (zero) sample columns each add this to the
# g′ row sum, and the masked iteration subtracts it.
_GPRIME_AT_ZERO = {"logcosh": 1.0, "exp": 1.0, "cube": 0.0}


def logcosh(x):
    """The tanh contrast (ref: ica.rs:383-398): ``(tanh(x),
    mean(1 − tanh²(x), axis=1))`` — G and the per-row mean of g′.

    >>> g, gp = logcosh(torch.tensor([[1.0, 2.0]], dtype=torch.float64))
    >>> round(float(g[0, 0]), 8), round(float(gp[0]), 8)
    (0.76159416, 0.24531258)
    """
    x = torch.as_tensor(x)
    g, s = _contrast_sums("logcosh", x)
    return g, s / x.shape[1]


# Below this the float32 convergence functional is roundoff noise
# (k·eps_f32 rotations a step): the "f32" stage hands off to ds64 here.
_F32_LIM_FLOOR = 1e-5

# Below this the ds64 stage's functional is dominated by its split
# products' and float32 contrast's error; it hands off to float64.
_DS64_LIM_FLOOR = 2e-6


def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as the JAX package holds ``tol``
    in the iterate's real dtype."""
    return float(torch.tensor(value, dtype=dtype))


def _k4_takes(w, decorr) -> bool:
    """True when K4 runs the update of ``w``: ``decorr`` is
    :func:`symmetric_decorrelation_ns` (at its default iteration count)
    and ``w`` a real float32 k×k on CUDA with k ≤ ``ica_update.K_MAX``."""
    return decorr is symmetric_decorrelation_ns and ica_update.supports(w)


def _update(w, gx, gsum, decorr, p_inv: float, pad_g0: float):
    if _k4_takes(w, decorr):
        with span("petal.ica.decorrelate"):
            return ica_update.ica_update(w, gx, gsum, p_inv, pad_g0)
    g_wtx = (gsum - pad_g0) * p_inv
    # W1 = symdecorr(G·Xᵀ/p − diag(g′)·W)  (ref: ica.rs:333-343)
    w_new = gx * p_inv - g_wtx[:, None] * w
    with span("petal.ica.decorrelate"):
        w1 = decorr(w_new)
    # lim = max_i ||row_i(W1)·col_i(W)| − 1|  (ref: ica.rs:344-354)
    lim = ((w1 * w.mT).sum(1).abs() - 1.0).abs().max()
    return w1, lim


def _sums(w, xs, part):
    """``(G·Xᵀ, g′ row sums)`` of one step: ``part(w, xs)`` on one
    tensor, or on every column block of a mesh's ``Columns`` with the
    two reduced together (one ``psum`` a step)."""
    with span("petal.ica.sums"):
        if not isinstance(xs, Columns):
            return part(w, xs)

        def both(block, wd):
            gx, gsum = part(wd, block)
            return torch.cat([gx, gsum[:, None]], dim=1)

        out = xs.psum(both, w)
        return out[:, :-1], out[:, -1]


def _step(w, xs, fun: str, decorr, p_inv: float, pad_g0: float = 0.0):
    """One fixed-point update of W on the rows of ``xs`` (a tensor, or
    the column blocks of a mesh): ``(W1, lim)``.  ``p_inv`` is 1/n;
    ``pad_g0`` the g′ row-sum share of padded columns."""
    def part(wd, x):
        gwtx, gsum = _contrast_sums(fun, mdot(wd, x))  # ica.rs:332
        return mdot(gwtx, x.mT), gsum

    return _update(w, *_sums(w, xs, part), decorr, p_inv, pad_g0)


def _step_ds(w, xh, xl, fun: str, decorr, p_inv: float,
             pad_g0: float = 0.0):
    """:func:`_step` of the ds64 stage: the two products as split
    float32 products of the pre-split data ``(xh, xl)``, the contrast in
    float32, the state in float64.  On a mesh ``xh`` holds each column
    block's ``(hi, lo)`` pair and ``xl`` is None."""
    def part(wd, hl):
        h, lo = hl
        wx32 = splitmm.mm_split_f32(wd, h, lo)
        gwtx, gsum = _contrast_sums(fun, wx32, sum_dtype=torch.float64)
        return splitmm.mm_split_chunked_f64(gwtx, h, lo), gsum

    xs = xh if xl is None else (xh, xl)
    return _update(w, *_sums(w, xs, part), decorr, p_inv, pad_g0)


def _iterate(body, w, tol: float, budget: int, lim_dtype):
    """``lax.while_loop`` with the cond ``(lim >= tol) & (it < budget)``
    and ``lim`` starting at inf: ``(w, lim, it)``.  The stop test reads
    ``lim`` on the host once a step (the ``petal.ica.lim_read`` span: the
    host blocked until the card has run the step)."""
    with span("petal.ica.iterate"):
        lim = torch.full((), math.inf, dtype=lim_dtype, device=w.device)
        lim_host, it = math.inf, 0
        while lim_host >= tol and it < budget:
            w, lim = body(w)
            with span("petal.ica.lim_read"):
                lim_host = float(lim)
            it += 1
        return w, lim, it


def _ica_par_core(x, tol: float, max_iter: int, w_init, fun: str,
                  n_valid: int | None = None, decorrelation: str = "eigh",
                  precision: str = "full"):
    """The FastICA fixed-point iteration (ref: ica.rs:319-361):
    ``(w, lim, n_iter)``.

    ``x`` is the k × n tensor, or its column blocks on a mesh
    (:class:`..parallel.mesh.Columns`), whose per-step sums are reduced
    over the blocks.  ``n_valid``: the number of real sample columns
    when ``x`` is zero-padded; the g′ sums are corrected so padded
    columns count for nothing.  ``precision="f32"`` (float64 data only)
    runs three stages within the shared ``max_iter`` budget, each until
    its own noise floor or ``tol``, whichever is larger: float32
    products and contrast to ``_F32_LIM_FLOOR``; split-float32 products
    (``ops/splitmm.py``) with a float32 contrast and float64 state to
    ``_DS64_LIM_FLOOR``; float64 to ``tol``.  ``lim`` is the last stage
    that ran's.
    """
    n_pad = x.shape[1]
    n = n_pad if n_valid is None else n_valid
    pad = n_pad - n
    g0 = _GPRIME_AT_ZERO[fun]
    if decorrelation not in ("eigh", "ns"):
        # "auto" is resolved by the caller (resolve_decorrelation).
        raise ValueError(f"unknown decorrelation {decorrelation!r}")
    decorr = (symmetric_decorrelation_ns if decorrelation == "ns"
              else symmetric_decorrelation)
    # The random W₀'s conditioning is unbounded: always the exact eigh.
    w0 = symmetric_decorrelation(w_init)
    step = dict(fun=fun, decorr=decorr, p_inv=1.0 / n,  # ref: ica.rs:330
                pad_g0=pad * g0)

    def body_on(xs):
        return lambda w: _step(w, xs, **step)

    def body_ds(xh, xl):
        return lambda w: _step_ds(w, xh, xl, **step)

    real = _common.real_dtype(x.dtype)
    if precision == "f32" and x.dtype == torch.float64:
        f32 = torch.float32
        tol32 = _rounded(max(tol, _F32_LIM_FLOOR), f32)
        x32 = (x.to(f32) if isinstance(x, torch.Tensor)
               else x.map(lambda p: p.to(f32)))
        w32, lim32, n1 = _iterate(body_on(x32), w0.to(f32), tol32,
                                  max_iter, f32)
        # Re-orthonormalize at full precision before polishing: the
        # float32 W carries ~eps_f32 departures from orthonormality.
        w_b = symmetric_decorrelation(w32.to(x.dtype))
        xh, xl = (splitmm.split_f64(x) if isinstance(x, torch.Tensor)
                  else (x.map(splitmm.split_f64), None))
        w_d, lim_d, nd = _iterate(body_ds(xh, xl), w_b,
                                  max(tol, _DS64_LIM_FLOOR), max_iter - n1,
                                  real)
        w, lim, n2 = _iterate(body_on(x), w_d, tol, max_iter - n1 - nd, real)
        if n2 == 0:
            # The budget ran out upstream: report the last stage that ran
            # (a non-converged fit, n_iter == max_iter, ica.rs:360).
            lim = lim_d if nd > 0 else lim32.to(real)
        return w, lim, n1 + nd + n2
    return _iterate(body_on(x), w0, tol, max_iter, real)


def resolve_iteration_precision(setting: str, dtype: torch.dtype,
                                device_type: str) -> str:
    """``iteration_precision="auto"``: ``"f32"`` for float64 data on
    CUDA, ``"full"`` elsewhere — the JAX package's accelerator rule,
    keyed on the tensor's ``device.type``."""
    if setting != "auto":
        return setting
    return ("f32" if dtype == torch.float64 and device_type != "cpu"
            else "full")


def resolve_decorrelation(setting: str, device_type: str) -> str:
    """``decorrelation="auto"``: Newton–Schulz (``"ns"``) on CUDA and
    eigh on the CPU — the JAX package's accelerator rule, keyed on the
    tensor's ``device.type``."""
    if setting != "auto":
        return setting
    return "ns" if device_type != "cpu" else "eigh"


def resolve_whiten_solver(setting: str, dtype: torch.dtype,
                          device_type: str) -> str:
    """``whiten_solver="auto"``: the reference's SVD whitening
    (ica.rs:189), except float64 on CUDA, which takes the d×d Gram and
    its eigh (K3) — the JAX package's accelerator rule, keyed on the
    tensor's ``device.type``."""
    if setting != "auto":
        return setting
    return ("eigh" if dtype == torch.float64 and device_type != "cpu"
            else "svd")


def ica_par(x, tol, max_iter: int, w_init, fun: str = "logcosh",
            decorrelation: str = "eigh", precision: str = "full"):
    """Symmetric FastICA iteration (ref: ica.rs:319-361) on the rows of
    ``x`` (k × n) from ``w_init`` (k × k).  ``decorrelation`` takes
    ``"auto"`` (:func:`resolve_decorrelation`), ``"eigh"`` or ``"ns"``.

    Returns ``(w, n_iter)``; ``n_iter == max_iter`` when the tolerance
    was never reached (ica.rs:360).

    >>> x = torch.tensor([[-0.5, 0.5], [-0.3, 0.3]], dtype=torch.float64)
    >>> w0 = torch.tensor([[1.0, 2.0], [3.0, 4.0]], dtype=torch.float64)
    >>> w, n = ica_par(x, 0.5, 1, w0)
    >>> round(float(w[0, 0]), 8), n
    (0.51449576, 1)
    """
    x = torch.as_tensor(x)
    w_init = torch.as_tensor(w_init, device=x.device)
    w, _, n_iter = _ica_par_core(
        x, _rounded(tol, _common.real_dtype(x.dtype)), int(max_iter),
        w_init, fun,
        decorrelation=resolve_decorrelation(decorrelation, x.device.type),
        precision=precision,
    )
    return w, int(n_iter)


def decorrelation_certificate(w: torch.Tensor) -> torch.Tensor:
    """``max|G² − G|`` for ``G = W·Wᴴ``: 0 when G is an orthogonal
    projector, the exact invariant of the pseudo-inverse decorrelation
    (G = I at full rank; a projector onto the data's span when k exceeds
    its rank).  In-loop eigensolves do not report failures one by one;
    they accumulate into this end-state measure."""
    g = mdot(w, w.mH)
    return (mdot(g, g) - g).abs().max()


def check_decorrelation_value(err, dtype: torch.dtype,
                              what: str = "symmetric decorrelation") -> None:
    """Raise ``LinalgError`` when a decorrelation certificate exceeds
    eps**0.25 (failures are O(1)); a NaN certificate fails."""
    if not _config.check_convergence:
        return
    tol = float(torch.finfo(dtype).eps) ** 0.25
    if not (float(err) <= tol):
        raise LinalgError(f"{what} did not converge")


def check_decorrelation(w: torch.Tensor,
                        what: str = "symmetric decorrelation") -> None:
    """:func:`check_decorrelation_value` on ``w``'s own certificate."""
    check_decorrelation_value(decorrelation_certificate(w),
                              _common.real_dtype(w.dtype), what)


def _whitening_matrix(xt: torch.Tensor, k: int, solver: str):
    """``(K, sigma_k, off)``: K such that K·Xᵀ has decorrelated rows
    (ref: ica.rs:189-203, all d columns filled).  ``svd``: from the thin
    SVD of Xᵀ (d × n); ``eigh``: from the eigendecomposition of the d×d
    Gram Xᵀ·X, with its certificate ``off``."""
    if solver == "svd":
        # linalg.svd raises LinalgError itself on non-convergence.
        u, sigma, _ = _linalg.svd(xt, compute_vt=False)
        off = torch.zeros((), dtype=sigma.dtype, device=sigma.device)
        kmat, sigma_k, _ = _whitening_from_spectrum(u, sigma, k,
                                                    max(xt.shape))
        return kmat, sigma_k, off
    return whitening_from_gram(mdot(xt, xt.mH), k, max(xt.shape))


def whitening_from_gram(gram: torch.Tensor, k: int, rank_dim: int):
    """``(K, sigma_k, off)`` from the centered d×d Gram; ``rank_dim`` is
    max(n, d) for the rank cutoff."""
    lam, vecs, off = _linalg.eigh_psd_jit_cert(gram)  # ascending
    u = vecs.flip(1)
    sigma = torch.sqrt(torch.clamp(lam.flip(0), min=0.0))
    kmat, sigma_k, _ = _whitening_from_spectrum(u, sigma, k, rank_dim)
    return kmat, sigma_k, off


def _whitening_from_spectrum(u, sigma, k: int, rank_dim: int):
    """``(K, sigma_k, 1/sigma_k)`` with the rank cutoff applied."""
    u_k = u[:, :k]
    sigma_k = sigma[:k]
    # σ below σmax·eps·max(10, 4√max(n, d)) is numerically zero and
    # whitens to 0 rather than amplifying roundoff by 1/σ.  The √ growth
    # tracks accumulated rounding; a linear max(n, d) would over-prune
    # float32 at large n.
    eps = torch.finfo(sigma_k.dtype).eps
    cutoff = sigma[0] * eps * max(10.0, 4.0 * rank_dim ** 0.5)
    ok = sigma_k > cutoff
    inv = torch.where(ok, 1.0 / torch.where(ok, sigma_k, 1.0), 0.0)
    kmat = (u_k * inv.to(u_k.dtype)[None, :]).mT
    return kmat, sigma_k, inv


def _unmix(x, components, means):
    """``(x − μ)·Wᵀ`` at the promoted dtype of ``x`` and ``W``."""
    if x.shape[1] != means.shape[0]:
        raise InvalidInput("too many columns")
    target = torch.promote_types(x.dtype, components.dtype)
    return mdot(x.to(target) - means, components.mT.to(target))


class FastIca:
    """FastICA with symmetric decorrelation (ref: ica.rs:41-222).

    Examples
    --------
    >>> import numpy as np
    >>> x = np.array([[0., 0.], [1., 1.], [1., -1.]])
    >>> y = FastIcaBuilder().seed(42).device("cpu").build().fit_transform(x)
    >>> tuple(y.shape)
    (3, 2)
    """

    def __init__(self, *, seed: int | None = None, fun: str = "logcosh",
                 tol: float = 1e-4, max_iter: int = 200, whiten: bool = True,
                 whiten_solver: str = "auto", mesh=None,
                 n_components: int | None = None,
                 decorrelation: str = "auto",
                 iteration_precision: str = "auto", device=None):
        if fun not in _CONTRASTS:
            raise ValueError(f"unknown contrast function {fun!r}")
        if whiten_solver not in ("auto", "svd", "eigh"):
            raise ValueError(f"unknown whiten solver {whiten_solver!r}")
        # whiten=False (sklearn semantics): the caller certifies the data
        # is centered and whitened; the fit runs ica_par on Xᵀ as it is
        # and components_ IS the square unmixing W.
        self._whiten = bool(whiten)
        if not self._whiten and n_components is not None:
            raise InvalidInput(
                "n_components requires whiten=True (whiten=False fits "
                "the square unmixing W over all features)"
            )
        if decorrelation not in ("auto", "eigh", "ns"):
            raise ValueError(f"unknown decorrelation {decorrelation!r}")
        if iteration_precision not in ("auto", "f32", "full"):
            raise ValueError(
                f"unknown iteration precision {iteration_precision!r}"
            )
        self._mesh = mesh
        self._decorrelation = decorrelation
        self._iteration_precision = iteration_precision
        self._n_components = (
            None if n_components is None else int(n_components)
        )
        # An explicit u128 seed, else a random one.
        self._gen = rng_util.generator_from_seed(
            rng_util.random_seed() if seed is None else seed
        )
        self._fun = fun
        self._tol = float(tol)  # ref hardcodes 1e-4 (ica.rs:216)
        self._max_iter = int(max_iter)  # ref hardcodes 200 (ica.rs:216)
        self._whiten_solver = whiten_solver
        self._device = _common.model_device(mesh, device)
        self._components = None  # (k, d)
        self._means = None  # (d,)
        self._n_iter = 0

    @classmethod
    def new(cls) -> "FastIca":
        return cls()

    @classmethod
    def with_seed(cls, seed: int) -> "FastIca":
        return cls(seed=seed)

    def components(self):
        return self._components

    def mean(self):
        return self._means

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def n_iter_(self) -> int:
        """Iterations used by the last fit (ica.rs:49,219)."""
        return self._n_iter

    components_ = property(lambda self: self._components)
    mean_ = property(lambda self: self._means)

    # -- fitting (ref: ica.rs:105-157) ----------------------------------
    def fit(self, x) -> "FastIca":
        x = _common.as_input(x, self._device, self._mesh, complex_ok=True)
        with _common.fit_record(self, x, self._mesh) as stats:
            self._inner_fit(x)
            stats.n_iter = self._n_iter
        return self

    def fit_batched(self, data, *, block_rows: int | None = None) -> "FastIca":
        """Out-of-core fit in two streamed passes: pass 1 accumulates the
        d×d Gram and moments (→ the eigh whitening K), pass 2 streams
        ``X₁ = K·(X − μ)ᵀ·√n`` into a k×n buffer on the device, and
        ``ica_par`` runs on it as in core.  ``data`` must be re-iterable:
        a 2-D array-like such as ``np.memmap``, a sequence of blocks, or
        a zero-arg callable returning the stream; k×n must fit device
        memory (checked).  Matches the in-core ``whiten_solver="eigh"``
        fit of the same seed up to accumulation roundoff.  Returns
        ``self``.

        >>> import numpy as np
        >>> rng = np.random.default_rng(0)
        >>> x = rng.laplace(size=(600, 3)) @ rng.standard_normal((3, 3))
        >>> m = FastIca(seed=42, device="cpu").fit_batched([x[:256], x[256:]])
        >>> tuple(m.components().shape)
        (3, 3)
        """
        from . import streaming

        return streaming.stream_fit_fast_ica(self, data,
                                             block_rows=block_rows)

    def transform_batched(self, blocks, *, block_rows: int | None = None):
        """Unmix a stream block by block; returns the stacked (n, k)
        result as a CPU tensor."""
        from . import streaming

        return streaming.transform_batched(self, blocks,
                                           block_rows=block_rows)

    @property
    def mixing_(self):
        """The pseudo-inverse of ``components_``, shape (d, k): the
        estimated mixing matrix.  Computed once per fit, cached on the
        components tensor's identity."""
        _common.check_fitted(self._components)
        cache = getattr(self, "_mixing_cache", None)
        if cache is None or cache[0] is not self._components:
            c = self._components
            eps = torch.finfo(_common.real_dtype(c.dtype)).eps
            # jnp.linalg.pinv's default cutoff, 10·max(k, d)·eps.
            self._mixing_cache = (
                c, torch.linalg.pinv(c, rtol=10.0 * max(c.shape) * eps)
            )
        return self._mixing_cache[1]

    def inverse_transform(self, y):
        """``y·mixing_ᵀ + μ``: an exact round trip of ``transform`` when
        k = d.

        >>> import numpy as np
        >>> x = np.array([[0., 1.], [2., 0.], [1., 3.], [3., 2.]])
        >>> m = FastIca(seed=42, device="cpu").fit(x)
        >>> bool((m.inverse_transform(m.transform(x)).numpy() - x).max() < 1e-8)
        True
        """
        y = _common.as_matrix(y, self._device, complex_ok=True)
        _common.check_fitted(self._components)
        if y.shape[1] != self._components.shape[0]:
            raise InvalidInput(
                f"# of columns should be {self._components.shape[0]}"
            )
        target = torch.promote_types(y.dtype, self._components.dtype)
        return mdot(y.to(target), self.mixing_.mT.to(target)) + self._means

    def transform(self, x):
        """(x − μ)·Wᵀ (ref: ica.rs:120-131); row shards are unmixed each
        on its own device and gathered."""
        _common.check_fitted(self._components)
        if isinstance(x, Rows):
            return _common.project_rows(x, self._mesh, _unmix,
                                        self._components, self._means)
        return _unmix(_common.as_matrix(x, self._device, complex_ok=True),
                      self._components, self._means)

    def fit_transform(self, x):
        """Fit, then return ``(components·X_c)ᵀ`` (ref: ica.rs:147-157)."""
        x = _common.as_input(x, self._device, self._mesh, complex_ok=True)
        with _common.fit_record(self, x, self._mesh) as stats:
            xt_c = self._inner_fit(x)
            stats.n_iter = self._n_iter
        if xt_c is None:  # a mesh fit: the same result by the projection
            return self.transform(x)
        return mdot(self._components, xt_c).mT

    def _resolved(self, dtype: torch.dtype):
        device_type = self._device.type
        return dict(
            fun=self._fun,
            decorrelation=resolve_decorrelation(self._decorrelation,
                                                device_type),
            precision=resolve_iteration_precision(
                self._iteration_precision, dtype, device_type),
        )

    def _inner_fit(self, x):
        """ref: ica.rs:167-221.  Returns the centered, transposed data
        (d × n), as the reference does, or None for a mesh fit."""
        # Complex on an accelerator mesh is a defined error.
        _common.check_mesh_complex(self._mesh, x.dtype)
        n, d = _common.n_rows(x), x.shape[1]
        if not self._whiten:
            if n == 0 or d == 0:
                raise InvalidInput(
                    "whiten=False requires non-empty data (the square "
                    "d x d unmixing W is undefined for empty input)"
                )
            return self._fit_no_whiten(x)
        k = min(n, d)  # ref: ica.rs:173
        if self._n_components is not None:
            if self._n_components > k:
                raise InvalidInput(f"n_components should be at most {k}")
            k = self._n_components
        if k == 0:
            # 0 samples, 0 features or n_components=0: the model is left
            # fitted with an empty component matrix, so transform and
            # fit_transform degrade gracefully (ica.rs:174-176 returns
            # early and leaves the build state).
            x = _common.gathered(x, n).to(self._device)
            means = (x.mean(0) if n > 0 else
                     torch.zeros((d,), dtype=x.dtype, device=x.device))
            self._components = torch.zeros((0, d), dtype=x.dtype,
                                           device=x.device)
            self._means = means
            self._n_iter = 0
            if n == 0:
                return torch.zeros((d, 0), dtype=x.dtype, device=x.device)
            return (x - means).mT
        if self._mesh is not None:
            return self._fit_mesh(x, k)

        means = x.mean(0)
        xt = (x - means).mT  # (d, n) — ref: ica.rs:178-188
        solver = resolve_whiten_solver(self._whiten_solver, x.dtype,
                                       x.device.type)
        with span("petal.ica.whiten"):
            kmat, _sigma, whiten_off = _whitening_matrix(xt, k, solver)
            if solver == "eigh":
                _linalg.check_certificate(
                    whiten_off, _common.real_dtype(x.dtype), d,
                    "eigendecomposition")
            # X₁ = K·Xᵀ·√n (ref: ica.rs:204-208): unit-variance rows under
            # the 1/n inner product.
            x1 = mdot(kmat, xt) * math.sqrt(n)
        sub = rng_util.split(self._gen)
        w_init = rng_util.normal(sub, (k, k), x.dtype, x.device)
        w, n_iter = ica_par(x1, self._tol, self._max_iter, w_init,
                            **self._resolved(x.dtype))
        check_decorrelation(w)
        self._components = mdot(w, kmat)  # ref: ica.rs:217
        self._means = means
        self._n_iter = n_iter
        return xt

    def _fit_no_whiten(self, x):
        """``whiten=False``: ``ica_par`` on Xᵀ as it is; ``components_``
        is the square unmixing W and the means are zero, so ``transform``
        is ``x·Wᵀ``."""
        d = x.shape[1]
        if self._mesh is not None:
            return self._fit_mesh(x, d)
        xt = x.mT
        sub = rng_util.split(self._gen)
        w_init = rng_util.normal(sub, (d, d), x.dtype, x.device)
        w, n_iter = ica_par(xt, self._tol, self._max_iter, w_init,
                            **self._resolved(x.dtype))
        check_decorrelation(w)
        self._components = w.contiguous()  # as Pca's
        self._means = torch.zeros((d,), dtype=_common.real_dtype(x.dtype),
                                  device=x.device)
        self._n_iter = n_iter
        return xt

    def _fit_mesh(self, x, k: int):
        """The fit on the mesh's row shards (JAX ``models/fast_ica.py:
        594-633``), whitened (k components) or not (k = d): W₀ from the
        next sub-stream of the generator, ``fast_ica_fit`` on the padded
        shards, then the certificates — the whitening eigensolve's only
        when it ran — before any state changes.  Returns None:
        ``fit_transform`` projects with ``transform``."""
        from ..parallel.distributed import fast_ica_fit

        sub = rng_util.split(self._gen)
        xs, _ = _common.mesh_shards(x, self._mesh)
        w_init = rng_util.normal(sub, (k, k), x.dtype, self._device)
        real = _common.real_dtype(x.dtype)
        st = fast_ica_fit(
            xs, w_init, tol=self._tol, max_iter=self._max_iter,
            n_components=k if self._whiten else None, whiten=self._whiten,
            **self._resolved(x.dtype),
        )
        if self._whiten:
            _linalg.check_certificate(st["off"], real, x.shape[1],
                                      "eigendecomposition")
        check_decorrelation_value(st["w_orth_err"], real)
        self._components = st["components"].contiguous()
        self._means = st["means"]
        self._n_iter = int(st["n_iter"])
        return None


class FastIcaBuilder:
    """Builder mirroring ``FastIcaBuilder`` (ref: ica.rs:244-317).

    >>> ica = FastIcaBuilder().seed(1234567891011121314).device("cpu").build()
    """

    def __init__(self):
        self._seed = None
        self._fun = "logcosh"
        self._tol = 1e-4
        self._max_iter = 200
        self._whiten = True
        self._whiten_solver = "auto"
        self._mesh = None
        self._n_components = None
        self._decorrelation = "auto"
        self._iteration_precision = "auto"
        self._device = None

    @classmethod
    def new(cls) -> "FastIcaBuilder":
        return cls()

    def seed(self, seed: int) -> "FastIcaBuilder":
        self._seed = seed
        return self

    def fun(self, fun: str) -> "FastIcaBuilder":
        self._fun = fun
        return self

    def tol(self, tol: float) -> "FastIcaBuilder":
        self._tol = tol
        return self

    def max_iter(self, max_iter: int) -> "FastIcaBuilder":
        self._max_iter = max_iter
        return self

    def whiten(self, whiten: bool) -> "FastIcaBuilder":
        """``False``: the data is certified centered and whitened; the
        fit runs ``ica_par`` directly and ``components_`` is the square
        unmixing W."""
        self._whiten = whiten
        return self

    def whiten_solver(self, solver: str) -> "FastIcaBuilder":
        """``"svd"``, ``"eigh"`` or ``"auto"``."""
        self._whiten_solver = solver
        return self

    def mesh(self, mesh) -> "FastIcaBuilder":
        """Row-shard fits over a :class:`..parallel.mesh.Mesh`."""
        self._mesh = mesh
        return self

    def n_components(self, n_components: int) -> "FastIcaBuilder":
        """Keep only the top-k whitened directions (the reference always
        uses min(n, d), ica.rs:173)."""
        self._n_components = n_components
        return self

    def decorrelation(self, method: str) -> "FastIcaBuilder":
        """In-loop decorrelation: ``"eigh"``, ``"ns"`` (Newton–Schulz)
        or ``"auto"`` (:func:`resolve_decorrelation`)."""
        self._decorrelation = method
        return self

    def iteration_precision(self, precision: str) -> "FastIcaBuilder":
        """``"full"`` (the data's dtype), ``"f32"`` (float32, then ds64,
        then float64 stages for float64 data) or ``"auto"``
        (:func:`resolve_iteration_precision`)."""
        self._iteration_precision = precision
        return self

    def device(self, device) -> "FastIcaBuilder":
        """The device the model's fits and state live on."""
        self._device = device
        return self

    def build(self) -> FastIca:
        return FastIca(
            seed=self._seed,
            fun=self._fun,
            tol=self._tol,
            max_iter=self._max_iter,
            whiten=self._whiten,
            whiten_solver=self._whiten_solver,
            mesh=self._mesh,
            n_components=self._n_components,
            decorrelation=self._decorrelation,
            iteration_precision=self._iteration_precision,
            device=self._device,
        )
