"""Randomized (Halko) truncated-SVD principal component analysis — the
counterpart of ``petal_decomposition_tpu/models/randomized_pca.py``
(ref: pca.rs:317-718).

Reference defaults are preserved: oversampling k+10 (pca.rs:679), 7
power iterations (pca.rs:680), LU → P·L normalization between them on
the CPU (pca.rs:709-713), and total variance as the squared Frobenius
norm of the centered data (pca.rs:533), not Σσ².

Every tensor of a model lives on its ``device``.  On CUDA the autos
mirror the JAX package's accelerator autos, on the CPU its CPU autos:
the default-constructor fit of a tall float32 matrix on CUDA therefore
takes the zero-pass Gram-algebra recovery, which runs no hand-written
kernel; ``range_finder("gram").gram_projection("data")`` takes the route
through the fused sketch+moments kernel (K1) and the Jacobi SVD kernel
(K2).  Streamed fits (``fit_batched``, ``partial_fit``,
``transform_batched``) and device meshes are not ported yet.
"""

from __future__ import annotations

import torch

from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops.linalg import cholesky_qr2, lu_pl, mdot, qr, svd_flip, svddc
from ..utils import rng as rng_util
from . import _common

__all__ = [
    "RandomizedPca",
    "RandomizedPcaBuilder",
    "randomized_svd",
    "randomized_range_finder",
]

_NORMALIZERS = ("lu", "qr", "cholqr2", "none")


def randomized_range_finder(x, size: int, n_iter: int, gen: torch.Generator,
                            normalizer: str = "lu"):
    """Orthonormal basis approximating range(x) (ref: pca.rs:689-718):
    Gaussian sketch Ω (d × size) from ``gen``, Y = X·Ω, ``n_iter`` power
    iterations alternating Xᵀ·norm(Y) and X·norm(·), then an economy QR.
    """
    if normalizer not in _NORMALIZERS:
        raise ValueError(f"unknown normalizer {normalizer!r}")
    omega = rng_util.normal(gen, (x.shape[1], size), x.dtype, x.device)
    q = mdot(x, omega)

    def norm(m):
        if normalizer == "lu":
            return lu_pl(m)  # (rows, min) — P·L, ref: pca.rs:709-713
        if normalizer == "qr":
            return qr(m)
        if normalizer == "cholqr2":
            return cholesky_qr2(m)
        return m

    for _ in range(n_iter):
        q = mdot(x.mT, norm(q))
        q = mdot(x, norm(q))
    return qr(q)


def randomized_svd(x, n_components: int, gen: torch.Generator, *,
                   n_oversamples: int = 10, n_power_iters: int = 7,
                   power_iteration_normalizer: str = "lu"):
    """Truncated randomized SVD (ref: pca.rs:665-686): ``(u, sigma, vt)``
    with l = n_components + n_oversamples columns/rows."""
    q = randomized_range_finder(
        x, n_components + n_oversamples, n_power_iters, gen,
        normalizer=power_iteration_normalizer,
    )
    u_b, sigma, vt = svddc(mdot(q.mT, x))  # ref: pca.rs:681-682
    u, vt = svd_flip(mdot(q, u_b), vt)  # ref: pca.rs:683-684
    return u, sigma, vt


class RandomizedPca:
    """Halko randomized-SVD PCA (ref: pca.rs:317-551).

    Examples
    --------
    >>> import numpy as np
    >>> x = np.array([[0., 0.], [3., 4.], [6., 8.]])
    >>> pca = RandomizedPca(1, seed=1234567891011121314, device="cpu")
    >>> y = pca.fit_transform(x)
    >>> bool(abs(abs(float(y[0, 0])) - 5.0) < 1e-8)
    True
    """

    def __init__(self, n_components: int, *, seed: int | None = None,
                 generator: torch.Generator | None = None,
                 centering: bool = True, n_oversamples: int = 10,
                 n_power_iters: int = 7,
                 power_iteration_normalizer: str = "auto", mesh=None,
                 finder_precision: str = "auto",
                 range_finder: str = "auto",
                 gram_precision: str = "auto",
                 gram_projection: str = "auto",
                 device=None):
        if n_components < 0:
            raise InvalidInput("n_components must be non-negative")
        _common.reject_mesh(mesh)
        if power_iteration_normalizer not in ("auto",) + _NORMALIZERS:
            raise ValueError(
                f"unknown normalizer {power_iteration_normalizer!r}"
            )
        if finder_precision not in ("auto", "f32", "full"):
            raise ValueError(f"unknown finder precision {finder_precision!r}")
        if range_finder not in ("auto", "direct", "gram"):
            raise ValueError(f"unknown range finder {range_finder!r}")
        if gram_precision not in ("auto", "default", "high", "highest"):
            raise ValueError(f"unknown gram precision {gram_precision!r}")
        if gram_projection not in ("auto", "data", "gram"):
            raise ValueError(f"unknown gram projection {gram_projection!r}")
        self._n_components = int(n_components)
        self._centering = bool(centering)
        self._n_oversamples = int(n_oversamples)
        self._n_power_iters = int(n_power_iters)
        self._normalizer = power_iteration_normalizer
        self._finder_precision = finder_precision
        self._range_finder = range_finder
        self._gram_precision = gram_precision
        self._gram_projection = gram_projection
        self._device = (
            _common.default_device() if device is None
            else torch.device(device)
        )
        if generator is not None:
            self._gen = generator
        else:
            # ref: pca.rs:342-359 — explicit u128 seed, else random seed.
            seed = rng_util.random_seed() if seed is None else seed
            self._gen = rng_util.generator_from_seed(seed)
        self._components = None
        self._means = None
        self._singular = None
        self._singular_full = None
        self._total_variance = None
        self._n_samples = 0

    # Constructors mirroring the reference (pca.rs:342-381).
    @classmethod
    def with_seed(cls, n_components: int, seed: int) -> "RandomizedPca":
        return cls(n_components, seed=seed)

    @classmethod
    def with_generator(cls, n_components: int,
                       generator: torch.Generator) -> "RandomizedPca":
        return cls(n_components, generator=generator)

    # -- accessors (ref: pca.rs:390-419) --------------------------------
    def components(self):
        return self._components

    def mean(self):
        return self._means

    def n_components(self) -> int:
        return self._n_components

    def singular_values(self):
        return self._singular

    @property
    def device(self) -> torch.device:
        return self._device

    def explained_variance_ratio(self):
        """σᵢ²/‖X−μ‖²_F (ref: pca.rs:414-419 with pca.rs:533)."""
        _common.check_fitted(self._singular)
        return self._singular * self._singular / self._total_variance

    components_ = property(lambda self: self._components)
    mean_ = property(lambda self: self._means)
    singular_values_ = property(lambda self: self._singular)

    @property
    def explained_variance_ratio_(self):
        return self.explained_variance_ratio()

    @property
    def explained_variance_(self):
        """Per-component variance σᵢ²/(n−1) (sklearn-compatible)."""
        _common.check_fitted(self._singular)
        denom = max(self._n_samples - 1, 1)
        return (self._singular * self._singular) / denom

    # -- fitting (ref: pca.rs:430-550) ----------------------------------
    def fit(self, x) -> "RandomizedPca":
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x, self._device)
        with record_fit(self, x.shape[0], x.shape[1], self._device):
            self._inner_fit(x)
        return self

    def transform(self, x):
        return _common.transform(
            _common.as_matrix(x, self._device), self._components,
            self._means, self._centering,
        )

    def fit_transform(self, x):
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x, self._device)
        with record_fit(self, x.shape[0], x.shape[1], self._device):
            u = self._inner_fit(x)
        return _common.transform_with_u(
            u, self._singular_full, self._n_components
        )

    def inverse_transform(self, y):
        return _common.inverse_transform(
            y, self._components, self._means, self._centering,
        )

    def _resolve_normalizer(self, x) -> str:
        """``"auto"``: LU→P·L on the CPU (the reference's normalizer),
        matmul-only CholeskyQR2 on the accelerator."""
        if self._normalizer != "auto":
            return self._normalizer
        return "lu" if x.device.type == "cpu" else "cholqr2"

    def _inner_fit(self, x):
        from ..parallel.distributed import randomized_pca_fit

        k = self._n_components
        _common.check_min_dims(x, k)
        n, d = x.shape
        if n == 0:
            self._singular_full = torch.zeros(
                (0,), dtype=_common.real_dtype(x.dtype), device=x.device
            )
            return torch.zeros((0, d), dtype=x.dtype, device=x.device)

        # Successive fits consume successive sub-streams — the
        # stateful-RNG contract of the reference (its PCG advances).
        sub = rng_util.split(self._gen)
        l = min(k + self._n_oversamples, n, d)
        omega = rng_util.normal(sub, (d, l), x.dtype, x.device)

        # Large fits on the accelerator take the fast rounding-
        # equivalent route: fused rank-1 centering and matmul-only
        # CholeskyQR2 final orthonormalization.  Small fits and CPU fits
        # keep the reference-parity rounding.
        accel = x.device.type != "cpu"
        accel_fast = accel and n * d >= (1 << 22)
        final_orth = "cholqr2" if accel_fast else "qr"
        if not accel_fast and accel and x.dtype == torch.float64:
            final_orth = "cholqr2"
        # The fused sketch+moments kernel (K1) on the Gram-finder path.
        # No availability probe: on CUDA it builds and launches or
        # raises.
        fused_ok = (
            accel_fast
            and x.dtype == torch.float32
            and self._range_finder != "direct"
            and self._gram_precision in ("auto", "default")
        )
        st = randomized_pca_fit(
            x, omega,
            n_components=k,
            centering=self._centering,
            n_oversamples=self._n_oversamples,
            n_power_iters=self._n_power_iters,
            normalizer=self._resolve_normalizer(x),
            fuse_centering=accel_fast,
            final_orth=final_orth,
            finder_precision=self._finder_precision,
            range_finder=self._range_finder,
            gram_precision=self._gram_precision,
            gram_projection=self._gram_projection,
            fused_sketch=fused_ok,
        )
        u, sigma, vt = st["u"], st["sigma"], st["vt"]
        # Check before mutating: a failed refit must leave a previously
        # fitted model untouched.
        _linalg.check_certificate(
            st["off"], sigma.dtype, d, "singular value decomposition"
        )
        # Frobenius² of the centered data, NOT σ·σ (ref: pca.rs:533).
        self._total_variance = st["total_variance"]
        self._components = vt[:k, :]
        self._n_samples = n
        self._means = st["means"]
        self._singular = sigma[:k]
        self._singular_full = sigma
        return u


class RandomizedPcaBuilder:
    """Builder mirroring ``RandomizedPcaBuilder`` (ref: pca.rs:564-663).

    >>> pca = RandomizedPcaBuilder(1).seed(1234567891011121314).build()
    """

    def __init__(self, n_components: int):
        self._n_components = n_components
        self._seed = None
        self._generator = None
        self._centering = True
        self._n_oversamples = 10
        self._n_power_iters = 7
        self._normalizer = "auto"
        self._mesh = None
        self._finder_precision = "auto"
        self._range_finder = "auto"
        self._gram_precision = "auto"
        self._gram_projection = "auto"
        self._device = None

    @classmethod
    def new(cls, n_components: int) -> "RandomizedPcaBuilder":
        return cls(n_components)

    @classmethod
    def with_generator(cls, generator: torch.Generator,
                       n_components: int) -> "RandomizedPcaBuilder":
        b = cls(n_components)
        b._generator = generator
        return b

    def seed(self, seed: int) -> "RandomizedPcaBuilder":
        self._seed = seed
        return self

    def centering(self, centering: bool) -> "RandomizedPcaBuilder":
        self._centering = centering
        return self

    def n_oversamples(self, n: int) -> "RandomizedPcaBuilder":
        self._n_oversamples = n
        return self

    def n_power_iters(self, n: int) -> "RandomizedPcaBuilder":
        self._n_power_iters = n
        return self

    def power_iteration_normalizer(self, norm: str) -> "RandomizedPcaBuilder":
        self._normalizer = norm
        return self

    def mesh(self, mesh) -> "RandomizedPcaBuilder":
        """Not ported yet: ``build()`` raises ``NotImplementedError`` for
        a mesh."""
        self._mesh = mesh
        return self

    def finder_precision(self, precision: str) -> "RandomizedPcaBuilder":
        """``"auto"`` | ``"f32"`` | ``"full"`` (see
        ``distributed.randomized_pca_fit``)."""
        self._finder_precision = precision
        return self

    def range_finder(self, finder: str) -> "RandomizedPcaBuilder":
        """``"auto"`` | ``"direct"`` | ``"gram"``."""
        self._range_finder = finder
        return self

    def gram_precision(self, precision: str) -> "RandomizedPcaBuilder":
        """``"auto"`` | ``"default"`` | ``"high"`` | ``"highest"`` (all
        IEEE float32 Grams in the port so far)."""
        self._gram_precision = precision
        return self

    def gram_projection(self, projection: str) -> "RandomizedPcaBuilder":
        """``"auto"`` | ``"data"`` | ``"gram"``."""
        self._gram_projection = projection
        return self

    def device(self, device) -> "RandomizedPcaBuilder":
        """The device the model's fits and state live on."""
        self._device = device
        return self

    def build(self) -> RandomizedPca:
        return RandomizedPca(
            self._n_components,
            seed=self._seed,
            generator=self._generator,
            centering=self._centering,
            n_oversamples=self._n_oversamples,
            n_power_iters=self._n_power_iters,
            power_iteration_normalizer=self._normalizer,
            mesh=self._mesh,
            finder_precision=self._finder_precision,
            range_finder=self._range_finder,
            gram_precision=self._gram_precision,
            gram_projection=self._gram_projection,
            device=self._device,
        )
