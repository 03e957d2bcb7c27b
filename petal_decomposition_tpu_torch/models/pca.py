"""Exact (full-SVD) principal component analysis — the counterpart of
``petal_decomposition_tpu/models/pca.py`` (ref: pca.rs:41-283).

The fit centers the data, takes its thin SVD, fixes the signs with
``svd_flip`` and keeps the leading components.  On CUDA the SVD runs
through the hand-written Jacobi kernels (``ops/jacobi.py``): K3 for
float64, directly or on the R factor of a tall Householder QR, and K2
for float32 likewise; ``solver="gram"`` takes the covariance
eigenproblem, whose float64 eigensolve is K3 as well.  Complex data
goes through ``torch.linalg`` on the model's device.  Under the
``"native"`` backend, and under ``"auto"`` for a table on the card of
at most ``config.host_offload_max_elements`` elements, the exact fit
runs on the host C++ core (:func:`_fit_native`).  ``fit_batched``,
``partial_fit`` and ``transform_batched`` stream row blocks
(:mod:`.streaming`).  On a mesh (``mesh=``, :mod:`..parallel.mesh`) the
``"auto"`` solver is the Gram route, its d×d Gram reduced over the row
shards and its eigensolve replicated; ``solver="full"`` gathers the
padded matrix and takes its SVD with the padded rows masked.
"""

from __future__ import annotations

import torch

from ..errors import InvalidInput
from ..ops import linalg as _linalg
from ..ops.kernels import jacobi_kernels
from ..ops.centered import mask_rows
from ..ops.linalg import svd_flip, svd_jit_cert
from . import _common

__all__ = ["Pca", "PcaBuilder"]


def _fit_exact(x, *, centering: bool, n_valid: int | None = None):
    """The whole exact-SVD fit (ref: pca.rs:195-231): ``(u, sigma, vt,
    means, total_variance, off)`` with the total variance Σσ².

    ``n_valid``: the true row count when ``x`` carries zero rows padded
    for even sharding.  The means divide by it and the padded rows are
    re-zeroed after centering, so σ, Vᵀ and the total variance are the
    unpadded fit's (zero rows add only zero singular values); the
    caller cuts U back to ``n_valid`` rows."""
    n, d = x.shape
    if centering:
        # Padded rows are zeros: the column sum is the data rows' sum.
        means = x.sum(0) / (n if n_valid is None else n_valid)
        xc = x - means
    else:
        means = torch.zeros((d,), dtype=x.dtype, device=x.device)
        xc = x
    xc = mask_rows(xc, n_valid)
    u, sigma, vt, off = svd_jit_cert(xc)
    u, vt = svd_flip(u, vt)
    return u, sigma, vt, means, sigma @ sigma, off


def _fit_native(x, *, centering: bool):
    """The exact fit on the host C++ core (JAX ``models/pca.py:313-340``):
    one copy of ``x`` to the host, centering and the SVD there in
    float64, ``svd_flip`` on the host, the results back on ``x``'s
    device and dtype: ``(u, sigma, vt, means, total_variance)``."""
    import numpy as np

    from ..utils import native

    xh = x.cpu().numpy()
    if centering:
        means_h = xh.mean(axis=0, dtype=np.float64)
        xc = xh - means_h
    else:
        means_h = np.zeros((xh.shape[1],), np.float64)
        xc = xh
    u_h, sigma_h, vt_h = _linalg.native_call(native.jacobi_svd, xc)
    # svd_flip (reference convention, pca.rs:815-850).
    idx = np.argmax(np.abs(u_h), axis=0)
    piv = u_h[idx, np.arange(u_h.shape[1])]
    signs = np.where(piv < 0, -1.0, 1.0)
    u_h = u_h * signs[None, :]
    vt_h = vt_h * signs[:, None]

    def back(a):
        return torch.from_numpy(a).to(x.device, x.dtype)

    total_var = torch.tensor(float(sigma_h @ sigma_h), dtype=x.dtype,
                             device=x.device)
    return back(u_h), back(sigma_h), back(vt_h), back(means_h), total_var


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
        self._n_components = int(n_components)
        self._centering = bool(centering)
        self._mesh = mesh
        # "full": thin SVD of the data (1e-10 parity path).
        # "gram": covariance eigenproblem (κ² in σ, one d×d Gram; the
        #   scalable row-sharded path).
        # "auto": gram on a mesh, else where _auto_prefers_gram says so.
        self._solver = solver
        self._device = _common.model_device(mesh, device)
        self._components = None  # (k, d)
        self._means = None  # (d,)
        self._singular = None  # (k,) real
        self._singular_full = None
        self._total_variance = None  # real scalar
        self._n_samples = 0
        self._stream = None  # partial_fit's accumulator

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
        x = _common.as_input(x, self._device, self._mesh, complex_ok=True)
        with _common.fit_record(self, x, self._mesh):
            self._inner_fit(x)
        return self

    def transform(self, x):
        """Apply the learned projection (ref: pca.rs:130-135); row shards
        are projected each on its own device and gathered."""
        return _common.transform_input(
            x, self._device, self._mesh, self._components, self._means,
            self._centering,
        )

    def fit_transform(self, x):
        """Fit and project in one pass, reusing U (ref: pca.rs:153-167)."""
        x = _common.as_input(x, self._device, self._mesh, complex_ok=True)
        with _common.fit_record(self, x, self._mesh):
            u = _common.gathered(self._inner_fit(x), _common.n_rows(x))
        return _common.transform_with_u(
            u, self._singular_full, self._n_components
        )

    def inverse_transform(self, y):
        """Back-project to the original space (ref: pca.rs:176-184)."""
        return _common.inverse_transform(
            y, self._components, self._means, self._centering,
        )

    def fit_batched(self, blocks, *, block_rows: int | None = None) -> "Pca":
        """Out-of-core fit from a stream of row blocks (or one 2-D
        array-like sliced on the host, e.g. an ``np.memmap``): one pass
        accumulates the d×d Gram and moments on the device, then the
        covariance eigenproblem gives the components.  Accuracy and sign
        contract in :mod:`.streaming`.  Returns ``self``.

        >>> import numpy as np
        >>> x = np.arange(12.0).reshape(6, 2)
        >>> m = Pca(1, device="cpu").fit_batched([x[:4], x[4:]], block_rows=4)
        >>> bool(abs(float(m.singular_values_[0]) - 140 ** 0.5) < 1e-8)
        True
        """
        from . import streaming

        return streaming.stream_fit_exact(self, blocks, block_rows=block_rows)

    def transform_batched(self, blocks, *, block_rows: int | None = None):
        """Project a stream block by block; returns the stacked (n, k)
        result as a CPU tensor."""
        from . import streaming

        return streaming.transform_batched(self, blocks,
                                           block_rows=block_rows)

    def partial_fit(self, x, *, block_rows: int | None = None) -> "Pca":
        """Incremental out-of-core fit: accumulate ``x`` (a block, an
        iterable of blocks, or a 2-D array-like) into the model's stream
        and re-solve, so the model is fitted after every call (sklearn
        ``IncrementalPCA`` semantics).  Any ``fit``/``fit_batched``
        restarts the stream.  Returns ``self``."""
        from . import streaming

        streaming.partial_fit_step(self, x, block_rows=block_rows,
                                   solve=streaming._solve_exact)
        return self

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
        """ref: pca.rs:195-231.  Returns U: row shards for a Gram fit on
        a mesh, else a tensor."""
        from ..parallel.distributed import pca_fit_gram

        self._stream = None  # a full fit restarts any partial_fit stream
        mesh = self._mesh
        # Complex on an accelerator mesh is a defined error.
        _common.check_mesh_complex(mesh, x.dtype)
        k = self._n_components
        _common.check_min_dims(x, k)
        n, d = _common.n_rows(x), x.shape[1]
        if n == 0:
            # Empty input: the reference's mean_axis returns None and
            # inner_fit early-returns an empty U without updating state
            # (pca.rs:207-211).
            self._singular_full = torch.zeros(
                (0,), dtype=_common.real_dtype(x.dtype), device=self._device
            )
            return torch.zeros((0, d), dtype=x.dtype, device=self._device)

        use_gram = self._solver == "gram" or (
            self._solver == "auto"
            and (mesh is not None or self._auto_prefers_gram(x))
        )
        if mesh is not None:
            xs, _ = _common.mesh_shards(x, mesh)
        # Certificates are checked before any state mutates: a failed
        # refit leaves a previously fitted model untouched.
        if use_gram:
            st = pca_fit_gram(x if mesh is None else xs,
                              centering=self._centering)
            u, sigma, vt = st["u"], st["sigma"], st["vt"]
            means, total_var = st["means"], st["total_variance"]
            _linalg.check_certificate(
                st["off"], sigma.dtype, d, "eigendecomposition"
            )
        elif mesh is None and _linalg._use_native(x.dtype, x.shape,
                                                  x.device):
            u, sigma, vt, means, total_var = _fit_native(
                x, centering=self._centering
            )
        else:
            # On a mesh the SVD is replicated: the padded matrix is
            # gathered on each process's first device and its padded rows
            # masked.
            u, sigma, vt, means, total_var, off = _fit_exact(
                x if mesh is None else xs.full(), centering=self._centering,
                n_valid=None if mesh is None else n,
            )
            u = u[:n]
            _linalg.check_certificate(
                off, sigma.dtype, max(n, d), "singular value decomposition"
            )
        self._total_variance = total_var
        # Contiguous, as a loaded model's are: transform then takes the
        # same GEMM path on a saved and on a loaded model.
        self._components = vt[:k, :].contiguous()
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
        """Row-shard fits over a :class:`..parallel.mesh.Mesh`."""
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
