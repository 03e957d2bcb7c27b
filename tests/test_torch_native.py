"""The port's host C++ core (``utils/native.py``), the ``"native"``
backend and the tiny-fit host offload, against the JAX package's native
bindings at 1e-12 — the counterparts of ``tests/test_native.py``."""

import re
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from petal_decomposition_tpu import Pca as JaxPca
from petal_decomposition_tpu import config as jax_config
from petal_decomposition_tpu.utils import native as jax_native
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops import linalg
from petal_decomposition_tpu_torch.utils import native

BAND = 1e-12


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.fixture
def jax_core(monkeypatch):
    """The JAX package's bindings, on the library the port built from
    the same source and flags (its own loader would run ``make`` in
    ``native/``, which ``tests/test_native.py`` may be running at the
    same time in another worker)."""
    monkeypatch.setattr(jax_native, "_LIB", native.load())
    return jax_native


@pytest.fixture
def backend(monkeypatch):
    """Set the port's and the JAX package's ``linalg_backend`` for one
    test."""
    def set_backend(name):
        monkeypatch.setattr(pt.config, "linalg_backend", name)
        monkeypatch.setattr(jax_config, "linalg_backend", name)
    return set_backend


@pytest.mark.parametrize("shape", [(40, 8), (8, 40), (20, 20)])
def test_native_svd(jax_core, shape):
    a = np.random.default_rng(0).standard_normal(shape)
    u, s, vt = native.jacobi_svd(a)
    uj, sj, vtj = jax_core.jacobi_svd(a)
    k = min(shape)
    assert u.shape == (shape[0], k) and vt.shape == (k, shape[1])
    assert _rel(s, sj) < BAND and _rel(u, uj) < BAND and _rel(vt, vtj) < BAND
    assert np.abs((u * s) @ vt - a).max() < 1e-12
    assert np.abs(s - np.linalg.svd(a, compute_uv=False)).max() < 1e-12


def test_native_eigh(jax_core):
    a = np.random.default_rng(1).standard_normal((15, 15))
    a = a + a.T
    w, v = native.jacobi_eigh(a)
    wj, vj = jax_core.jacobi_eigh(a)
    assert _rel(w, wj) < BAND and _rel(v, vj) < BAND
    assert np.abs(w - np.linalg.eigvalsh(a)).max() < 1e-12
    assert np.all(np.diff(w) >= -1e-12)


def test_native_qr(jax_core):
    a = np.random.default_rng(2).standard_normal((30, 7))
    q = native.qr(a)
    assert _rel(q, jax_core.qr(a)) < BAND
    assert np.abs(q.T @ q - np.eye(7)).max() < 1e-13


def test_native_lu_pl(jax_core):
    a = np.random.default_rng(3).standard_normal((12, 5))
    pl = native.lu_pl(a)
    p, low, _ = sla.lu(a)
    assert _rel(pl, jax_core.lu_pl(a)) < BAND
    assert np.abs(pl - p @ low).max() < 1e-13


def test_native_matches_port_jacobi():
    """Oracle check, as the JAX test holds its core against its Jacobi:
    the core's σ against the port's Jacobi SVD (K3's plain version on a
    CPU tensor)."""
    a = np.random.default_rng(4).standard_normal((60, 12))
    _, s_native, _ = native.jacobi_svd(a)
    _, s_port, _ = linalg.svd(torch.from_numpy(a))
    assert np.abs(s_native - s_port.numpy()).max() < 1e-11


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_native_backend_pca(jax_core, backend, dtype):
    """A whole fit through ``linalg_backend="native"`` in both packages;
    float32 comes back at float32, as in the JAX package."""
    x = np.random.default_rng(5).standard_normal((80, 10)).astype(dtype)
    backend("native")
    m = pt.Pca(3, device="cpu")
    y = m.fit_transform(x)
    mj = JaxPca(3)
    yj = np.asarray(mj.fit_transform(x))
    assert y.dtype == torch.from_numpy(x).dtype
    band = BAND if dtype == np.float64 else 1e-6
    assert _rel(y.numpy(), yj) < band
    assert _rel(m.components_.numpy(), np.asarray(mj.components_)) < band
    assert _rel(m.singular_values_.numpy(),
                np.asarray(mj.singular_values_)) < band
    assert _rel(m.explained_variance_ratio_.numpy(),
                np.asarray(mj.explained_variance_ratio_)) < band
    assert _rel(m.transform(x).numpy(), np.asarray(mj.transform(x))) < band
    # The core against the port's own default route.
    backend("auto")
    assert _rel(y.numpy(), pt.Pca(3, device="cpu").fit_transform(x)
                .numpy()) < (1e-10 if dtype == np.float64 else 1e-5)


def test_native_backend_svd_and_eigh(jax_core, backend):
    """``ops.linalg.svd`` and ``eigh`` route to the core under
    ``"native"``, results on the input's device and dtype."""
    from petal_decomposition_tpu.ops import linalg as jax_linalg

    rng = np.random.default_rng(6)
    a = rng.standard_normal((30, 6))
    g = a.T @ a - 5.0 * np.eye(6)  # indefinite
    backend("native")
    u, s, vt = linalg.svd(torch.from_numpy(a))
    uj, sj, vtj = jax_linalg.svd(a)
    assert u.dtype == torch.float64 and not u.is_cuda
    assert _rel(s, sj) < BAND and _rel(u, uj) < BAND and _rel(vt, vtj) < BAND
    w, v = linalg.eigh(torch.from_numpy(g))
    wj, vj = jax_linalg.eigh(g)
    assert _rel(w, wj) < BAND and _rel(v, vj) < BAND
    assert linalg.svd(torch.from_numpy(a), compute_vt=False)[2] is None


def test_native_sweep_budget_and_error_taxonomy(monkeypatch):
    """The core honors an explicit sweep budget (rc=1 is NativeError) and
    ``native_call`` raises it as LinalgError at
    ``config.jacobi_max_sweeps``."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((60, 24)) * (1.5 ** -np.arange(24))[None, :]
    with pytest.raises(native.NativeError):
        native.jacobi_svd(a, max_sweeps=1)
    assert native.jacobi_svd(a)[1].shape == (24,)
    monkeypatch.setattr(pt.config, "jacobi_max_sweeps", 1)
    with pytest.raises(pt.LinalgError):
        linalg.native_call(native.jacobi_svd, a)
    monkeypatch.setattr(pt.config, "jacobi_max_sweeps", 30)
    linalg.native_call(native.jacobi_svd, a)


def test_use_native_decides_as_jax(monkeypatch):
    """``_use_native`` under each backend and offload size: the JAX
    rule, with a tensor's device in place of ``effective_platform()``;
    complex never goes to the real core."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    f64 = torch.float64
    assert not linalg._use_native(f64, (10, 4), cuda)  # offload off
    monkeypatch.setattr(pt.config, "host_offload_max_elements", 40)
    assert linalg._use_native(f64, (10, 4), cuda)
    assert not linalg._use_native(f64, (10, 5), cuda)  # too large
    assert not linalg._use_native(f64, (10, 4), cpu)  # already on the host
    assert not linalg._use_native(torch.complex128, (10, 4), cuda)
    monkeypatch.setattr(pt.config, "linalg_backend", "native")
    assert linalg._use_native(torch.float32, (1000, 1000), cpu)
    assert not linalg._use_native(torch.complex64, (4, 4), cpu)
    monkeypatch.setattr(pt.config, "linalg_backend", "jacobi")
    assert not linalg._use_native(f64, (10, 4), cuda)


def test_unbuildable_library_raises(monkeypatch, tmp_path):
    """A source that does not compile: ``available()`` is False, and the
    ``"native"`` backend and the offload raise naming the build error,
    where the JAX package's ``_use_native`` returns False and runs the
    factorization elsewhere (``ROADMAP.md`` §3)."""
    bad = tmp_path / "petal_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    assert not native.available()
    x = torch.from_numpy(np.random.default_rng(7).standard_normal((20, 4)))
    monkeypatch.setattr(pt.config, "linalg_backend", "native")
    for call in (lambda: linalg.svd(x), lambda: linalg.eigh(x.T @ x),
                 lambda: pt.Pca(2, device="cpu").fit(x)):
        with pytest.raises(native.NativeError, match="petal_native.cpp"):
            call()
    monkeypatch.setattr(pt.config, "linalg_backend", "auto")
    monkeypatch.setattr(pt.config, "host_offload_max_elements", 1 << 18)
    with pytest.raises(native.NativeError, match="failed"):
        linalg._use_native(torch.float64, (20, 4), torch.device("cuda"))
    assert not list((tmp_path / "build").glob("*.so"))
    # The JAX package, its library unbuildable (no Makefile), says False.
    from petal_decomposition_tpu.ops import linalg as jax_linalg

    monkeypatch.setattr(jax_native, "_native_dir", lambda: tmp_path)
    monkeypatch.setattr(jax_native, "_LIB", None)
    monkeypatch.setattr(jax_native, "_LOAD_TRIED", False)
    monkeypatch.setattr(jax_config, "linalg_backend", "native")
    assert jax_linalg._use_native(np.float64, (20, 4)) is False


def test_build_flags_are_the_makefiles():
    """The loader builds with ``native/Makefile``'s flags."""
    makefile = Path(native.SOURCE).with_name("Makefile").read_text()
    flags = re.search(r"^CXXFLAGS \?= (.*)$", makefile, re.M).group(1)
    assert tuple(flags.split()) == native.CXXFLAGS
    assert native.BUILD_DIR.parts[-2:] == ("build", "native")
