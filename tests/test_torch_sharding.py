"""Row-sharded fits of the PyTorch port on an eight-shard CPU mesh.

Three parts:

* the JAX package's mesh tests (``tests/test_sharding.py``,
  ``test_contracts.py:20-75``, ``test_convergence.py:69-102``,
  ``test_fast_ica.py:492``, ``test_gram_finder.py:108``,
  ``test_gram_projection.py:122``) on the port: a sharded fit gives the
  unsharded fit's outputs;
* parity with the JAX package's eight-device CPU mesh (the conftest's)
  at the same input and the same Ω or W₀: the pipelines and the models,
  on uneven rows too, at 1e-10 (float64) and 1e-5 (float32), relative —
  the port's reductions add the shards in another order than XLA's psum;
* on a card (``cuda``), K1 on two and four shards of one card, held
  against its plain version, with a padded last shard.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.models import fast_ica as jfi
from petal_decomposition_tpu.ops.pallas import sketch_kernel as jax_k1
from petal_decomposition_tpu.parallel import distributed as jdist
from petal_decomposition_tpu.parallel import mesh as jmesh
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch import config
from petal_decomposition_tpu_torch.models import _common
from petal_decomposition_tpu_torch.models import fast_ica as pfi
from petal_decomposition_tpu_torch.ops import jacobi, linalg
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1
from petal_decomposition_tpu_torch.parallel import distributed as pdist
from petal_decomposition_tpu_torch.parallel import (
    make_mesh,
    shard_rows,
    shard_rows_padded,
)
from petal_decomposition_tpu_torch.utils import rng as port_rng

RNG_SEED = 1_234_567_891_011_121_314
BAND = {np.float64: 1e-10, np.float32: 1e-5}
CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[CPU] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return jmesh.make_mesh(8)


def _np(t):
    return np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _rel(got, want) -> float:
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def _two_sources(n, seed):
    rng = np.random.default_rng(seed)
    s = np.stack([rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))],
                 axis=1)
    return s @ np.array([[1.0, 0.5], [0.3, 1.0]]), s


def _decaying(n, d, dtype=np.float64, seed=0, offset=0.5, decay=0.75):
    """Decaying spectrum (σⱼ ∝ decayʲ, well separated) plus a mean."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x = (rng.standard_normal((n, d)) * decay ** np.arange(d)) @ basis.T
    return (10 * x + offset * rng.standard_normal(d)).astype(dtype)


# -- the JAX package's mesh tests (tests/test_sharding.py) ------------


def test_mesh_has_eight_devices(mesh):
    assert mesh.size == 8 and len(mesh.devices) == 8


def test_shard_rows_places_on_mesh(mesh):
    x = np.arange(64.0).reshape(16, 4)
    xs = shard_rows(x, mesh)
    assert len(xs.shards) == 8
    assert all(tuple(s.shape) == (2, 4) for s in xs.shards)
    np.testing.assert_array_equal(np.asarray(xs), x)
    with pytest.raises(ValueError, match="shard_rows_padded"):
        shard_rows(x[:15], mesh)


def test_pca_gram_sharded_matches_full_svd(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 24))
    ref = pt.Pca(5, device=CPU).fit(x)
    sharded = pt.PcaBuilder(5).mesh(mesh).build().fit(x)
    np.testing.assert_allclose(_np(sharded.singular_values()),
                               _np(ref.singular_values()), rtol=1e-9)
    np.testing.assert_allclose(_np(sharded.components()),
                               _np(ref.components()), atol=1e-7)
    np.testing.assert_allclose(_np(sharded.explained_variance_ratio()),
                               _np(ref.explained_variance_ratio()),
                               rtol=1e-9)
    np.testing.assert_allclose(_np(sharded.transform(x)),
                               _np(ref.transform(x)), atol=1e-7)


def test_pca_gram_fit_transform_matches(mesh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((128, 16))
    y_sh = pt.PcaBuilder(4).mesh(mesh).build().fit_transform(x)
    y_ref = pt.Pca(4, device=CPU).fit_transform(x)
    np.testing.assert_allclose(_np(y_sh), _np(y_ref), atol=1e-7)


def test_pca_gram_solver_single_device_matches():
    """The Gram solver without a mesh: the same algorithm, one device."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((100, 12))
    y_g = pt.Pca(3, solver="gram", device=CPU).fit_transform(x)
    y_f = pt.Pca(3, solver="full", device=CPU).fit_transform(x)
    np.testing.assert_allclose(_np(y_g), _np(y_f), atol=1e-8)


def test_randomized_pca_sharded_matches_unsharded(mesh):
    """The same seed and the CholeskyQR2 normalizer on both paths: the
    same results to rounding."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 40))
    ref = (pt.RandomizedPcaBuilder(6).seed(RNG_SEED)
           .power_iteration_normalizer("cholqr2").device(CPU).build()).fit(x)
    sh = pt.RandomizedPcaBuilder(6).seed(RNG_SEED).mesh(mesh).build().fit(x)
    np.testing.assert_allclose(_np(sh.singular_values()),
                               _np(ref.singular_values()), rtol=1e-8)
    np.testing.assert_allclose(_np(sh.components()), _np(ref.components()),
                               atol=1e-7)


def test_randomized_pca_sharded_vs_exact_spectrum(mesh):
    rng = np.random.default_rng(4)
    u = rng.standard_normal((1024, 6))
    v = rng.standard_normal((6, 64))
    x = u @ np.diag([50, 40, 30, 20, 10, 5.0]) @ v
    x += 0.01 * rng.standard_normal(x.shape)
    sh = pt.RandomizedPcaBuilder(6).seed(RNG_SEED).mesh(mesh).build().fit(x)
    exact = pt.Pca(6, device=CPU).fit(x)
    np.testing.assert_allclose(_np(sh.singular_values()),
                               _np(exact.singular_values()), rtol=1e-5)


def test_fast_ica_sharded_recovers_sources(mesh):
    x, s = _two_sources(4096, 5)
    ica = pt.FastIcaBuilder().seed(42).mesh(mesh).build()
    y = _np(ica.fit_transform(x))
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)
    assert ica.n_iter_ >= 1


def test_fast_ica_sharded_ns_decorrelation_matches_unsharded(mesh):
    x, _ = _two_sources(2048, 8)
    # The unsharded fit whitens by the Gram's eigh too: the port's CPU SVD
    # and eigh whitenings differ in sign, which sends W₀ to a permuted
    # fixed point (the JAX package's two agree on this data).
    ref = (pt.FastIcaBuilder().seed(42).decorrelation("ns")
           .whiten_solver("eigh").device(CPU).build())
    ref.fit(x)
    sh = pt.FastIcaBuilder().seed(42).decorrelation("ns").mesh(mesh).build()
    sh.fit(x)
    c1, c2 = _np(ref.components()), _np(sh.components())
    # Per-row signs: ICA components are sign-indeterminate by nature.
    signs = np.sign(np.sum(c1 * c2, axis=1))[:, None]
    assert np.max(np.abs(c1 - c2 * signs)) < 1e-6


def test_fast_ica_sharded_matches_eigh_whitening_unsharded(mesh):
    x, _ = _two_sources(2048, 6)
    ref = pt.FastIcaBuilder().seed(42).whiten_solver("eigh").device(CPU)
    ref = ref.build().fit(x)
    sh = pt.FastIcaBuilder().seed(42).mesh(mesh).build().fit(x)
    assert ref.n_iter_ == sh.n_iter_
    np.testing.assert_allclose(_np(sh.components()), _np(ref.components()),
                               atol=1e-7)


def test_uneven_rows_shard(mesh):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((101, 12))
    y_sh = pt.PcaBuilder(3).mesh(mesh).build().fit_transform(x)
    y_ref = pt.Pca(3, device=CPU).fit_transform(x)
    np.testing.assert_allclose(_np(y_sh), _np(y_ref), atol=1e-7)


def test_pca_full_solver_mesh_matches_unsharded(mesh):
    """mesh + solver='full': padded rows pollute neither the means, the
    SVD nor the length of fit_transform."""
    rng = np.random.default_rng(17)
    x = rng.standard_normal((101, 12))  # 101 % 8 != 0: zero padding
    ref = pt.Pca(3, device=CPU).fit(x)
    sharded = pt.PcaBuilder(3).mesh(mesh).solver("full").build()
    y_sh = _np(sharded.fit_transform(x))
    assert y_sh.shape == (101, 3)
    np.testing.assert_allclose(_np(sharded.mean()), _np(ref.mean()),
                               atol=1e-12)
    np.testing.assert_allclose(_np(sharded.singular_values()),
                               _np(ref.singular_values()), rtol=1e-10)
    np.testing.assert_allclose(_np(sharded.components()),
                               _np(ref.components()), atol=1e-9)
    np.testing.assert_allclose(y_sh, _np(ref.fit_transform(x)), atol=1e-9)
    np.testing.assert_allclose(_np(sharded.explained_variance_ratio()),
                               _np(ref.explained_variance_ratio()),
                               rtol=1e-10)


def test_pca_full_solver_mesh_without_centering(mesh):
    rng = np.random.default_rng(19)
    x = rng.standard_normal((50, 8)) + 1.0
    ref = pt.PcaBuilder(2).centering(False).device(CPU).build().fit(x)
    sh = pt.PcaBuilder(2).centering(False).mesh(mesh).solver("full")
    sh = sh.build().fit(x)
    np.testing.assert_allclose(_np(sh.singular_values()),
                               _np(ref.singular_values()), rtol=1e-10)
    np.testing.assert_allclose(_np(sh.components()), _np(ref.components()),
                               atol=1e-9)


def test_fast_ica_sharded_mixed_precision_matches_unsharded(mesh):
    """The float32 → ds64 → float64 stages on the mesh reach the same
    float64 fixed point as the single-device mixed fit."""
    x, _ = _two_sources(2048, 6)
    ref = (pt.FastIcaBuilder().seed(42).whiten_solver("eigh").tol(1e-10)
           .iteration_precision("f32").device(CPU).build()).fit(x)
    sh = (pt.FastIcaBuilder().seed(42).mesh(mesh).tol(1e-10)
          .iteration_precision("f32").build()).fit(x)
    assert 1 <= sh.n_iter_ <= 200
    np.testing.assert_allclose(_np(sh.components()), _np(ref.components()),
                               atol=1e-7)


def test_mesh_model_complex_transform_not_redirected(mesh):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((64, 6))
    pca = pt.PcaBuilder(2).mesh(mesh).build().fit(x)
    z = rng.standard_normal((5, 6)) + 1j * rng.standard_normal((5, 6))
    y = _np(pca.transform(z))
    ref = (z - _np(pca.mean())) @ _np(pca.components()).conj().T
    np.testing.assert_allclose(y, ref, atol=1e-10)
    back = _np(pca.inverse_transform(y))
    assert back.shape == z.shape and np.all(np.isfinite(back.real))


# -- contracts (tests/test_contracts.py:20-75) ------------------------


def test_complex_cpu_mesh_fits_work(mesh):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 8)) + 1j * rng.standard_normal((64, 8))
    m = pt.Pca(2, mesh=mesh).fit(x)
    assert tuple(m.components_.shape) == (2, 8)
    ref = pt.Pca(2, device=CPU, solver="gram").fit(x)
    assert _rel(m.singular_values_, ref.singular_values_) < 1e-10


def test_complex_accelerator_mesh_raises():
    def fake_mesh(*types):  # only the devices are read
        return SimpleNamespace(
            devices=tuple(torch.device(t) for t in types))

    check = _common.check_mesh_complex
    with pytest.raises(pt.InvalidInput, match="accelerator mesh"):
        check(fake_mesh("cuda"), torch.complex64)
    with pytest.raises(pt.InvalidInput, match="accelerator mesh"):
        check(fake_mesh("cpu", "cuda"), torch.complex128)
    check(fake_mesh("cuda"), torch.float32)  # real dtypes pass
    check(fake_mesh("cpu", "cpu"), torch.complex128)  # and CPU meshes
    check(None, torch.complex128)


@pytest.mark.parametrize("model_cls", [pt.Pca, pt.RandomizedPca, pt.FastIca])
def test_mesh_guard_wired_into_models(model_cls, monkeypatch, mesh):
    calls = []
    orig = _common.check_mesh_complex

    def spy(m, dtype):
        calls.append(dtype)
        return orig(m, dtype)

    monkeypatch.setattr(_common, "check_mesh_complex", spy)
    x = np.random.default_rng(1).standard_normal((64, 8))
    model = (model_cls(mesh=mesh) if model_cls is pt.FastIca
             else model_cls(2, mesh=mesh))
    model.fit(x)
    assert len(calls) == 1


def test_mesh_model_lives_on_the_lead_device(mesh):
    assert pt.Pca(2, mesh=mesh).device == torch.device(CPU)
    with pytest.raises(ValueError, match="first device"):
        pt.Pca(2, mesh=mesh, device="cuda")


# -- certificates on the mesh paths (tests/test_convergence.py) -------


@pytest.fixture
def one_sweep(monkeypatch):
    """One Jacobi sweep, with the CPU fits sent through the card's rungs
    (K3's plain version for every float64 eigh), so every checked
    factorization has a sweep budget to exhaust."""
    real_eigh, real_route = linalg.eigh_psd_jit_cert, jacobi._route

    def eigh(a):
        if k3.supports(a.shape[0], a.shape[0], a.dtype):
            return linalg._eigh_psd_k3(a)
        return real_eigh(a)

    for mod in (linalg, pdist):
        monkeypatch.setattr(mod, "eigh_psd_jit_cert", eigh)
    monkeypatch.setattr(jacobi, "_route",
                        lambda m, n, dtype, _dev: real_route(m, n, dtype,
                                                             "cuda"))
    monkeypatch.setattr(config, "jacobi_max_sweeps", 1)


def _cert_data(n=96, d=24):
    rng = np.random.default_rng(5)
    return rng.standard_normal((n, d)) * (1.5 ** -np.arange(d))[None, :]


def test_sharded_randomized_path_raises(one_sweep, mesh):
    with pytest.raises(pt.LinalgError):
        pt.RandomizedPcaBuilder(3).seed(RNG_SEED).mesh(mesh).build().fit(
            _cert_data())


def test_sharded_gram_path_raises(one_sweep, mesh):
    with pytest.raises(pt.LinalgError):
        pt.PcaBuilder(3).mesh(mesh).build().fit(_cert_data())


def test_mesh_ica_path_raises(one_sweep, mesh):
    with pytest.raises(pt.LinalgError):
        pt.FastIcaBuilder().seed(RNG_SEED).mesh(mesh).build().fit(
            _cert_data())


def test_converged_mesh_fits_pass_checks(mesh):
    x = _cert_data()
    pt.PcaBuilder(3).mesh(mesh).build().fit(x)
    pt.PcaBuilder(3).mesh(mesh).solver("full").build().fit(x)
    pt.RandomizedPcaBuilder(3).seed(RNG_SEED).mesh(mesh).build().fit(x)
    pt.FastIcaBuilder().seed(RNG_SEED).mesh(mesh).build().fit(x)


# -- the other JAX mesh tests -----------------------------------------


def _prewhitened(n):
    rng = np.random.default_rng(0)
    s = rng.laplace(size=(n, 3))
    x = s @ rng.standard_normal((3, 3))
    xc = x - x.mean(0)
    u, _, _ = np.linalg.svd(xc, full_matrices=False)
    return u * np.sqrt(n)


def test_whiten_false_mesh_matches_single_device(mesh):
    """tests/test_fast_ica.py:492."""
    xw = _prewhitened(2048)
    single = pt.FastIcaBuilder().seed(5).whiten(False).device(CPU).build()
    single = single.fit(xw)
    meshed = pt.FastIcaBuilder().seed(5).whiten(False).mesh(mesh).build()
    meshed = meshed.fit(xw)
    assert single.n_iter_ == meshed.n_iter_
    np.testing.assert_allclose(_np(meshed.components_),
                               _np(single.components_), atol=1e-12)


def _gram_data(n=2003, d=48):
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, d)) * np.linspace(1, 12, d)
            ).astype(np.float32)


@pytest.mark.parametrize("projection", ["data", "gram"])
def test_gram_sharded_matches_unsharded(mesh, projection):
    """tests/test_gram_finder.py:108 and test_gram_projection.py:122:
    uneven rows exercise pad + mask."""
    x = _gram_data()
    m1 = pt.RandomizedPca(8, seed=RNG_SEED, range_finder="gram",
                          gram_projection=projection,
                          power_iteration_normalizer="cholqr2",
                          device=CPU).fit(x)
    m2 = (pt.RandomizedPcaBuilder(8).seed(RNG_SEED).range_finder("gram")
          .gram_projection(projection).mesh(mesh).build().fit(x))
    s1, s2 = _np(m1.singular_values_), _np(m2.singular_values_)
    assert np.max(np.abs(s1 - s2) / s1) < 1e-5
    c1, c2 = _np(m1.components_), _np(m2.components_)
    assert np.max(np.abs(c1 - c2)) < 1e-4


# -- parity with the JAX package's eight-device mesh -------------------


def test_shard_rows_padded_matches_jax(mesh, jax_mesh):
    x = np.arange(101 * 3, dtype=np.float64).reshape(101, 3)
    xs, n = shard_rows_padded(x, mesh)
    xj, nj = jmesh.shard_rows_padded(x, jax_mesh)
    assert (n, xs.shape) == (nj, xj.shape) == (101, (104, 3))
    np.testing.assert_array_equal(np.asarray(xs), np.asarray(xj))
    assert xs.valid == [13] * 7 + [10]
    xs, n = shard_rows_padded(x[:5], mesh)  # shards past the data
    assert n == 5 and xs.valid == [1] * 5 + [0] * 3


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [101, 256])
def test_pca_fit_gram_matches_jax(mesh, jax_mesh, dtype, n):
    x = _decaying(n, 12, dtype)
    xs, n_true = shard_rows_padded(x, mesh)
    xj, _ = jmesh.shard_rows_padded(x, jax_mesh)
    st = pdist.pca_fit_gram(xs)
    st_j = jdist.pca_fit_gram(
        xj, n_valid=None if n_true == xj.shape[0] else n_true,
        cfg=("port-parity", n))
    band = BAND[dtype]
    # float32 σ through the Gram square κ: the trailing directions are
    # Gram-grade, so float32 is held on the leading four (a model's k).
    k = 12 if dtype == np.float64 else 4
    assert _rel(st["sigma"][:k], np.asarray(st_j["sigma"])[:k]) < band
    assert _rel(st["vt"][:k], np.asarray(st_j["vt"])[:k]) < band
    assert _rel(st["means"], st_j["means"]) < band
    assert _rel(st["total_variance"], st_j["total_variance"]) < band
    assert _rel(st["u"].full()[:n, :k], np.asarray(st_j["u"])[:n, :k]) < band


_RANDOMIZED = [
    (np.float64, dict(range_finder="direct")),
    # LU and QR are not sums over the rows: the mesh gathers the panel.
    (np.float64, dict(range_finder="direct", normalizer="lu")),
    (np.float64, dict(range_finder="direct", normalizer="qr")),
    (np.float64, dict(range_finder="gram", gram_projection="data")),
    (np.float64, dict(range_finder="gram", gram_projection="gram")),
    (np.float32, dict(range_finder="gram", gram_projection="data")),
    (np.float32, dict(range_finder="gram", gram_projection="gram")),
]


@pytest.mark.parametrize("dtype,kw", _RANDOMIZED)
def test_randomized_pca_fit_matches_jax(mesh, jax_mesh, dtype, kw):
    """Both recoveries (the data-side projection and the zero-pass Gram
    algebra) and the direct finder's three normalizers at the JAX key's
    Ω, on 8 shards of 301 uneven rows."""
    x = _decaying(301, 24, dtype)
    k = 4
    key = jax_rng.key_from_seed(11)
    omega = np.array(jax_rng.normal(key, (24, k + 10), x.dtype))
    xs, n = shard_rows_padded(x, mesh)
    xj, _ = jmesh.shard_rows_padded(x, jax_mesh)
    st = pdist.randomized_pca_fit(xs, torch.from_numpy(omega),
                                  n_components=k, **kw)
    st_j = jdist.randomized_pca_fit(xj, key, n_components=k, n_valid=n,
                                    cfg=("port-parity",), **kw)
    band = BAND[dtype]
    for name in ("sigma", "means", "total_variance"):
        assert _rel(st[name], st_j[name]) < band, name
    assert _rel(st["vt"][:k], np.asarray(st_j["vt"])[:k]) < band
    y = st["u"].full()[:n, :k] * st["sigma"][:k]
    y_j = np.asarray(st_j["u"])[:n, :k] * np.asarray(st_j["sigma"])[:k]
    assert _rel(y, y_j) < band


def _whitening_signs(x, k):
    """D with K_port = D·K_jax for the eigh whitening of ``x``."""
    xt = np.ascontiguousarray((x - x.mean(0)).T)
    kj = np.asarray(jfi._whitening_matrix(jnp.asarray(xt), k, "eigh")[0])
    kp = pfi._whitening_matrix(torch.from_numpy(xt), k, "eigh")[0].numpy()
    d = np.sign(np.sum(kp * kj, axis=1))
    d[d == 0] = 1
    return d


@pytest.mark.parametrize("decorrelation", ["eigh", "ns"])
def test_fast_ica_fit_matches_jax(mesh, jax_mesh, decorrelation):
    """Ten steps from the JAX key's W₀ (aligned with the whitening's
    signs), so the two fits run the same updates; ``tol=0`` compares a
    fixed count, since the stop functional depends on the signs."""
    x, _ = _two_sources(2003, 6)
    key = jax_rng.key_from_seed(13)
    w0 = np.array(jax_rng.normal(key, (2, 2), x.dtype))
    w0 = w0 * _whitening_signs(x, 2)[None, :]
    xs, n = shard_rows_padded(x, mesh)
    xj, _ = jmesh.shard_rows_padded(x, jax_mesh)
    st = pdist.fast_ica_fit(xs, torch.from_numpy(w0), tol=0.0, max_iter=10,
                            decorrelation=decorrelation)
    st_j = jdist.fast_ica_fit(xj, key, tol=0.0, max_iter=10, n_valid=n,
                              decorrelation=decorrelation,
                              cfg=("port-parity",))
    assert int(st["n_iter"]) == int(st_j["n_iter"]) == 10
    assert _rel(st["components"], st_j["components"]) < 1e-10
    assert _rel(st["means"], st_j["means"]) < 1e-10


def test_fast_ica_fit_whiten_false_matches_jax(mesh, jax_mesh):
    xw = _prewhitened(1001)
    key = jax_rng.key_from_seed(17)
    w0 = np.array(jax_rng.normal(key, (3, 3), xw.dtype))
    xs, n = shard_rows_padded(xw, mesh)
    xj, _ = jmesh.shard_rows_padded(xw, jax_mesh)
    st = pdist.fast_ica_fit(xs, torch.from_numpy(w0), tol=0.0, max_iter=8,
                            whiten=False)
    st_j = jdist.fast_ica_fit(xj, key, tol=0.0, max_iter=8, n_valid=n,
                              whiten=False, cfg=("port-parity",))
    assert _rel(st["components"], st_j["components"]) < 1e-10


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jax_k1, "_INTERPRET", True)


def test_fused_sketch_moments_on_matches_jax(mesh, jax_mesh, interpret):
    """K1 on every shard (its plain version on the CPU) against the JAX
    kernel under ``shard_map`` in interpret mode, on uneven rows."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((32_771, 64)) + 0.2).astype(np.float32)
    w = rng.standard_normal((64, 11)).astype(np.float32)
    xs, n = shard_rows_padded(x, mesh)
    xj, _ = jmesh.shard_rows_padded(x, jax_mesh)
    ys, cs, sq = k1.fused_sketch_moments_on(xs, torch.from_numpy(w))
    yj, csj, sqj = jax_k1.fused_sketch_moments_on(xj, jnp.asarray(w),
                                                  jax_mesh)
    assert len(ys.shards) == 8
    assert _rel(ys.full()[:n], np.asarray(yj)[:n]) < BAND[np.float32]
    assert _rel(cs, csj) < BAND[np.float32]
    assert _rel(sq, sqj) < BAND[np.float32]


def test_fused_gram_pipeline_matches_jax(mesh, jax_mesh, interpret):
    """The Gram finder with K1 on every shard, uneven rows (pad and the
    masked ones column), against the JAX package's per-shard kernel
    pipeline (tests/test_sketch_kernel.py::test_mesh_pipeline_uneven_rows)."""
    rng = np.random.default_rng(42)
    x = ((rng.standard_normal((32_999, 64)) @ np.diag(np.linspace(1, 20, 64)))
         + 0.4).astype(np.float32)
    key = jax_rng.key_from_seed(11)
    omega = np.array(jax_rng.normal(key, (64, 16), np.float32))
    xs, n = shard_rows_padded(x, mesh)
    xj, _ = jmesh.shard_rows_padded(x, jax_mesh)
    common = dict(n_components=6, normalizer="cholqr2", range_finder="gram",
                  gram_precision="default", gram_projection="data",
                  fused_sketch=True)
    st = pdist.randomized_pca_fit(xs, torch.from_numpy(omega), **common)
    st_j = jdist.randomized_pca_fit(xj, key, n_valid=n, kernel_mesh=jax_mesh,
                                    cfg=("port-parity-k1",), **common)
    band = BAND[np.float32]
    assert _rel(st["sigma"][:6], np.asarray(st_j["sigma"])[:6]) < band
    assert _rel(st["means"], st_j["means"]) < band
    assert _rel(st["total_variance"], st_j["total_variance"]) < band


def _inject(monkeypatch, draw):
    def fake_normal(gen, shape, dtype, device):
        assert tuple(shape) == draw.shape
        return torch.from_numpy(draw).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_rng, "normal", fake_normal)


def _jax_draw(shape, dtype, seed):
    """What a JAX model's first fit draws (key split, then normal)."""
    _, sub = jax.random.split(jax_rng.key_from_seed(seed))
    return np.array(jax_rng.normal(sub, shape, dtype))


@pytest.mark.parametrize("solver", ["auto", "full"])
def test_pca_model_matches_jax_on_uneven_rows(mesh, jax_mesh, solver):
    x = _decaying(101, 12)
    m = pt.Pca(3, mesh=mesh, solver=solver)
    mj = jpd.Pca(3, mesh=jax_mesh, solver=solver)
    y, yj = m.fit_transform(x), mj.fit_transform(x)
    assert tuple(y.shape) == (101, 3)
    assert _rel(y, yj) < 1e-10
    assert _rel(m.singular_values_, mj.singular_values_) < 1e-10
    assert _rel(m.components_, mj.components_) < 1e-10
    assert _rel(m.explained_variance_ratio_, mj.explained_variance_ratio_) < (
        1e-10)
    assert _rel(m.transform(x), mj.transform(x)) < 1e-10


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_randomized_model_matches_jax_on_uneven_rows(monkeypatch, mesh,
                                                      jax_mesh, dtype):
    x = _decaying(101, 24, dtype)
    _inject(monkeypatch, _jax_draw((24, 14), dtype, 3))
    m = pt.RandomizedPca(4, seed=3, mesh=mesh)
    mj = jpd.RandomizedPca(4, seed=3, mesh=jax_mesh)
    y, yj = m.fit_transform(x), mj.fit_transform(x)
    band = BAND[dtype]
    assert _rel(y, yj) < band
    assert _rel(m.singular_values_, mj.singular_values_) < band
    assert _rel(m.components_, mj.components_) < band
    assert _rel(m.explained_variance_ratio_, mj.explained_variance_ratio_) < (
        band)


def test_fast_ica_model_matches_jax_on_uneven_rows(monkeypatch, mesh,
                                                   jax_mesh):
    x, _ = _two_sources(101, 6)
    _inject(monkeypatch,
            _jax_draw((2, 2), x.dtype, 7) * _whitening_signs(x, 2)[None, :])
    m = pt.FastIca(seed=7, mesh=mesh, tol=0.0, max_iter=10).fit(x)
    mj = jpd.FastIca(seed=7, mesh=jax_mesh, tol=0.0, max_iter=10).fit(x)
    assert m.n_iter_ == mj.n_iter_ == 10
    assert _rel(m.components_, mj.components_) < 1e-10
    assert _rel(m.transform(x), mj.transform(x)) < 1e-10


# -- on the card -------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_k1_per_shard_on_one_card(cuda_device, shards):
    """K1 on every shard of one card against its plain version per shard
    (the last shard padded), and the reduced moments against float64."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4096 * shards + 3, 256, generator=g, device="cuda") + 0.3
    w = torch.randn(256, 42, generator=g, device="cuda")
    card_mesh = make_mesh(shards, devices=["cuda"] * shards)
    xs, n = shard_rows_padded(x, card_mesh)
    assert xs.padded and xs.valid[-1] < xs.rows_per_shard
    before = k1.launches
    ys, cs, sq = k1.fused_sketch_moments_on(xs, w)
    assert k1.launches - before == shards
    for s, y in zip(xs.shards, ys.shards):
        yp, _, _ = k1._sketch_moments_plain(s, w)
        assert float((y - yp).abs().max()) <= 1e-5 * float(yp.abs().max())
    x64 = x.double()
    assert _rel(cs.cpu(), x64.sum(0).cpu()) < 1e-5
    assert abs(float(sq) - float((x64 * x64).sum())) / float(
        (x64 * x64).sum()) < 1e-5
