"""Exact (full-SVD) principal component analysis — the counterpart of
``petal_decomposition_tpu/models/pca.py`` (ref: pca.rs:41-283).

The fit centers the data, takes its thin SVD, fixes the signs with
``svd_flip`` and keeps the leading components.  On CUDA the SVD runs
through the hand-written Jacobi kernels (``ops/jacobi.py``): K3 for
float64, directly or on the R factor of a tall Householder QR, and K2
for float32 likewise; ``solver="gram"`` takes the covariance
eigenproblem, whose float64 eigensolve is K3 as well.  Complex data
goes through ``torch.linalg`` on the model's device.

Not ported yet: device meshes (``ROADMAP.md`` §1 item 8), the streamed
``fit_batched`` / ``partial_fit`` / ``transform_batched`` (item 6) and
the host-native offload (item 9, off by default in the JAX package).
"""

from __future__ import annotations

import torch

from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops.kernels import jacobi_kernels
from ..ops.linalg import svd_flip, svd_jit_cert
from . import _common

__all__ = ["Pca", "PcaBuilder"]


def _fit_exact(x, *, centering: bool):
    """The whole exact-SVD fit (ref: pca.rs:195-231): ``(u, sigma, vt,
    means, total_variance, off)`` with the total variance Σσ²."""
    n, d = x.shape
    if centering:
        means = x.sum(0) / n
        xc = x - means
    else:
        means = torch.zeros((d,), dtype=x.dtype, device=x.device)
        xc = x
    u, sigma, vt, off = svd_jit_cert(xc)
    u, vt = svd_flip(u, vt)
    return u, sigma, vt, means, sigma @ sigma, off


class Pca:
    """Exact PCA via full SVD (ref: pca.rs:41-232).

    Examples
    --------
    >>> import numpy as np
    >>> x = np.array([[0., 0.], [1., 1.], [2., 2.]])
    >>> y = PcaBuilder(1).device("cpu").build().fit_transform(x)
    >>> bool(abs(abs(float(y[0, 0])) - 2 ** 0.5) < 1e-8)
    True
    """

    def __init__(self, n_components: int, *, centering: bool = True,
                 mesh=None, solver: str = "auto", device=None):
        if n_components < 0:
            raise InvalidInput("n_components must be non-negative")
        if solver not in ("auto", "full", "gram"):
            raise ValueError(f"unknown solver {solver!r}")
        _common.reject_mesh(mesh)
        self._n_components = int(n_components)
        self._centering = bool(centering)
        # "full": thin SVD of the data (1e-10 parity path).
        # "gram": covariance eigenproblem (κ² in σ, one d×d Gram).
        # "auto": gram only where _auto_prefers_gram says so.
        self._solver = solver
        self._device = (
            _common.default_device() if device is None
            else torch.device(device)
        )
        self._components = None  # (k, d)
        self._means = None  # (d,)
        self._singular = None  # (k,) real
        self._singular_full = None
        self._total_variance = None  # real scalar
        self._n_samples = 0

    @classmethod
    def new(cls, n_components: int) -> "Pca":
        """Constructor alias mirroring ``Pca::new`` (ref: pca.rs:59-68)."""
        return cls(n_components)

    # -- accessors (ref: pca.rs:78-105) ---------------------------------
    def components(self):
        """Principal axes in feature space, shape (k, d)."""
        return self._components

    def mean(self):
        """Per-feature empirical mean (zeros when centering is off)."""
        return self._means

    def n_components(self) -> int:
        return self._n_components

    def singular_values(self):
        return self._singular

    @property
    def device(self) -> torch.device:
        return self._device

    def explained_variance_ratio(self):
        """σᵢ²/Σσⱼ² over *all* singular values (ref: pca.rs:101-105,224)."""
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

    # -- fitting --------------------------------------------------------
    def fit(self, x) -> "Pca":
        """Fit the model (ref: pca.rs:116-122).  Returns ``self``."""
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x, self._device, complex_ok=True)
        with record_fit(self, x.shape[0], x.shape[1], self._device):
            self._inner_fit(x)
        return self

    def transform(self, x):
        """Apply the learned projection (ref: pca.rs:130-135)."""
        return _common.transform(
            _common.as_matrix(x, self._device, complex_ok=True),
            self._components, self._means, self._centering,
        )

    def fit_transform(self, x):
        """Fit and project in one pass, reusing U (ref: pca.rs:153-167)."""
        from ..utils.profiling import record_fit

        x = _common.as_matrix(x, self._device, complex_ok=True)
        with record_fit(self, x.shape[0], x.shape[1], self._device):
            u = self._inner_fit(x)
        return _common.transform_with_u(
            u, self._singular_full, self._n_components
        )

    def inverse_transform(self, y):
        """Back-project to the original space (ref: pca.rs:176-184)."""
        return _common.inverse_transform(
            y, self._components, self._means, self._centering,
        )

    # Not ported yet: each raises NotImplementedError.
    fit_batched = transform_batched = partial_fit = staticmethod(
        _common.streamed_not_ported
    )

    @staticmethod
    def _auto_prefers_gram(x) -> bool:
        """``auto`` takes the Gram/eigh route only for float32 on CUDA
        where neither K2 route reaches: not the direct panel
        (``supports(n, d)``) and not the d×d R factor of the tall QR
        route (``supports(d_pad, d)``, which K2 takes up to d_pad = 632,
        as the JAX kernel's gate does), and only for n ≥ 8d, where one
        d×d Gram replaces an n-row QR.  So float32 with d ≥ 633 and
        n ≥ 8d fits through the Gram, where the JAX package sends it;
        narrower float32 panels, every float64 and
        complex fit, and every CPU fit take the SVD of the data.  The
        trade there: σ through the Gram square to ~eps·κ(X)²; pass
        ``solver="full"`` to force the direct SVD."""
        if x.dtype != torch.float32 or x.device.type == "cpu":
            return False
        n, d = x.shape
        direct_ok = jacobi_kernels.supports(n, d, x.dtype)
        qr_precond_ok = jacobi_kernels.supports(d + (d % 2), d, x.dtype)
        if direct_ok or qr_precond_ok:
            return False
        return n >= 8 * d

    def _inner_fit(self, x):
        """ref: pca.rs:195-231."""
        from ..parallel.distributed import pca_fit_gram

        k = self._n_components
        _common.check_min_dims(x, k)
        n, d = x.shape
        if n == 0:
            # Empty input: the reference's mean_axis returns None and
            # inner_fit early-returns an empty U without updating state
            # (pca.rs:207-211).
            self._singular_full = torch.zeros(
                (0,), dtype=_common.real_dtype(x.dtype), device=x.device
            )
            return torch.zeros((0, d), dtype=x.dtype, device=x.device)

        use_gram = self._solver == "gram" or (
            self._solver == "auto" and self._auto_prefers_gram(x)
        )
        # Certificates are checked before any state mutates: a failed
        # refit leaves a previously fitted model untouched.
        if use_gram:
            st = pca_fit_gram(x, centering=self._centering)
            u, sigma, vt = st["u"], st["sigma"], st["vt"]
            means, total_var = st["means"], st["total_variance"]
            _linalg.check_certificate(
                st["off"], sigma.dtype, d, "eigendecomposition"
            )
        else:
            u, sigma, vt, means, total_var, off = _fit_exact(
                x, centering=self._centering
            )
            _linalg.check_certificate(
                off, sigma.dtype, max(n, d), "singular value decomposition"
            )
        self._total_variance = total_var
        self._components = vt[:k, :]
        self._n_samples = n
        self._means = means
        self._singular = sigma[:k]
        self._singular_full = sigma
        return u


class PcaBuilder:
    """Builder mirroring the reference's ``PcaBuilder`` (pca.rs:246-283).

    >>> pca = PcaBuilder(2).centering(False).device("cpu").build()
    """

    def __init__(self, n_components: int):
        self._n_components = n_components
        self._centering = True
        self._mesh = None
        self._solver = "auto"
        self._device = None

    @classmethod
    def new(cls, n_components: int) -> "PcaBuilder":
        return cls(n_components)

    def centering(self, centering: bool) -> "PcaBuilder":
        self._centering = centering
        return self

    def mesh(self, mesh) -> "PcaBuilder":
        """Not ported yet: ``build()`` raises ``NotImplementedError`` for
        a mesh."""
        self._mesh = mesh
        return self

    def solver(self, solver: str) -> "PcaBuilder":
        """``'full'`` (thin SVD, 1e-10 parity), ``'gram'`` (covariance
        eigenproblem) or ``'auto'``."""
        self._solver = solver
        return self

    def device(self, device) -> "PcaBuilder":
        """The device the model's fits and state live on."""
        self._device = device
        return self

    def build(self) -> Pca:
        return Pca(
            self._n_components,
            centering=self._centering,
            mesh=self._mesh,
            solver=self._solver,
            device=self._device,
        )
