"""The ported slice — in-core ``RandomizedPca`` — against the JAX
package at the same Gaussian Ω: the fit functional on every route, the
models, their errors, the seeded stream, and state carried across."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from petal_decomposition_tpu import RandomizedPca as JaxRandomizedPca
from petal_decomposition_tpu import RandomizedPcaBuilder as JaxBuilder
from petal_decomposition_tpu.ops.pallas import sketch_kernel as jax_k1
from petal_decomposition_tpu.parallel.distributed import (
    randomized_pca_fit as jax_fit,
)
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1
from petal_decomposition_tpu_torch.parallel.distributed import (
    randomized_pca_fit,
)
from petal_decomposition_tpu_torch.utils import rng as port_rng
from petal_decomposition_tpu_torch.utils.convert import (
    randomized_pca_from_numpy,
)

BAND = {np.float64: 1e-10, np.float32: 1e-5}


def _data(n, d, dtype, offset=0.5, seed=0, decay=0.75):
    """Decaying spectrum (σⱼ ∝ decayʲ, well separated) plus a mean."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x = (rng.standard_normal((n, d)) * decay ** np.arange(d)) @ basis.T
    return (10 * x + offset * rng.standard_normal(d)).astype(dtype)


def _relmax(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _assert_same_fit(st, st_j, k, band, u_band=None):
    """σ, components, means, total variance, explained-variance ratio,
    U·σ (fit_transform) and its inverse image, within ``band`` (U·σ
    within ``u_band`` where given)."""
    s, s_j = st["sigma"].numpy()[:k], np.asarray(st_j["sigma"])[:k]
    assert _relmax(s, s_j) < band
    vt, vt_j = st["vt"].numpy()[:k], np.asarray(st_j["vt"])[:k]
    assert _relmax(vt, vt_j) < band
    assert _relmax(st["means"].numpy(), np.asarray(st_j["means"])) < band
    tv, tv_j = float(st["total_variance"]), float(st_j["total_variance"])
    assert abs(tv - tv_j) / tv_j < band
    assert _relmax(s * s / tv, s_j * s_j / tv_j) < band
    y = st["u"].numpy()[:, :k] * s
    y_j = np.asarray(st_j["u"])[:, :k] * s_j
    u_band = band if u_band is None else u_band
    assert _relmax(y, y_j) < u_band
    mu = st["means"].numpy()
    assert _relmax(y @ vt + mu, y_j @ vt_j + mu) < u_band


def _both_fits(x, k, cfg, **kw):
    """The JAX functional and the port's at the JAX key's Ω."""
    n, d = x.shape
    key = jax_rng.key_from_seed(11)
    l = min(k + 10, n, d)
    omega = np.array(jax_rng.normal(key, (d, l), x.dtype))
    st_j = jax_fit(jnp.asarray(x), key, n_components=k, cfg=cfg, **kw)
    st = randomized_pca_fit(torch.from_numpy(x), torch.from_numpy(omega),
                            n_components=k, **kw)
    return st, st_j


_F64, _F32 = np.float64, np.float32
_DIRECT = [
    (_F64, dict(normalizer="lu", fuse_centering=False, final_orth="qr")),
    (_F32, dict(normalizer="lu", fuse_centering=False, final_orth="qr")),
    (_F64, dict(normalizer="qr", fuse_centering=True)),
    (_F64, dict(normalizer="cholqr2", fuse_centering=True,
                final_orth="cholqr2")),
    (_F32, dict(normalizer="cholqr2", fuse_centering=True,
                final_orth="cholqr2")),
    (_F64, dict(normalizer="none", n_power_iters=0)),
]


@pytest.mark.parametrize(
    "dtype,kw", _DIRECT,
    ids=[f"{kw['normalizer']}-{dt.__name__}" for dt, kw in _DIRECT],
)
def test_fit_direct_finder(dtype, kw):
    x = _data(300, 24, dtype)
    st, st_j = _both_fits(x, 5, ("torch-direct", str(kw)), **kw)
    _assert_same_fit(st, st_j, 5, BAND[dtype])


@pytest.mark.parametrize(
    "dtype,offset",
    # 50: mean-dominated, past the float32 guard thresholds.
    [(_F64, 0.5), (_F32, 0.5), (_F32, 50.0)],
)
@pytest.mark.parametrize("projection", ["data", "gram"])
def test_fit_gram_finder(dtype, projection, offset):
    x = _data(400, 24, dtype, offset=offset)
    st, st_j = _both_fits(
        x, 5, ("torch-gram",), range_finder="gram",
        gram_projection=projection, normalizer="cholqr2",
        fuse_centering=True,
    )
    _assert_same_fit(st, st_j, 5, BAND[dtype])


@pytest.mark.parametrize("finder", ["direct", "gram"])
def test_fit_mixed_f64_finder(finder):
    """σ and components at the float64 band.  The float32 finder's basis
    error reaches the components only through the spectral tail beyond
    the sketch, so the spectrum here decays fast enough for that to sit
    under 1e-10.  U = Q·U_B keeps the float32 grade of Q in both
    packages (their contract is on σ), so U·σ is held to the f32 band."""
    x = _data(300, 24, np.float64, decay=0.5)
    st, st_j = _both_fits(
        x, 5, ("torch-mixed",), finder_precision="f32", range_finder=finder,
        normalizer="cholqr2",
    )
    _assert_same_fit(st, st_j, 5, BAND[np.float64], u_band=BAND[np.float32])


def test_fit_without_centering():
    x = _data(300, 24, np.float64, offset=2.0)
    st, st_j = _both_fits(x, 5, ("torch-nc",), centering=False,
                          normalizer="lu", fuse_centering=False)
    _assert_same_fit(st, st_j, 5, BAND[np.float64])
    assert not st["means"].any()


@pytest.mark.parametrize("offset", [0.5, 50.0])
def test_fit_fused_sketch_flow(monkeypatch, offset):
    """The kernel route: the JAX K1 under the interpreter, the port's
    plain K1 on the CPU; both widen Q with the ones column and drop it
    after the SVD of B."""
    monkeypatch.setattr(jax_k1, "_INTERPRET", True)
    x = _data(4200, 64, np.float32, offset=offset)
    kw = dict(range_finder="gram", gram_projection="data",
              gram_precision="default", normalizer="cholqr2",
              final_orth="cholqr2", fused_sketch=True)
    st, st_j = _both_fits(x, 6, ("torch-fused", offset), **kw)
    assert st["sigma"].shape == (16,) and st["u"].shape == (4200, 16)
    _assert_same_fit(st, st_j, 6, BAND[np.float32])


def test_resolved_autos_follow_device():
    from petal_decomposition_tpu_torch.parallel import distributed as dist

    big = (1_000_000, 1024, 42)
    assert dist._resolve_range_finder("auto", *big, "cuda") == "gram"
    assert dist._resolve_range_finder("auto", *big, "cpu") == "direct"
    assert dist._resolve_range_finder(
        "auto", *big, "cuda", full_f64=True) == "direct"
    assert dist._resolve_gram_projection("auto", "gram", False,
                                         "cuda") == "gram"
    assert dist._resolve_gram_projection("auto", "gram", False,
                                         "cpu") == "data"
    assert dist._resolve_gram_projection("auto", "gram", True,
                                         "cuda") == "data"
    with pytest.raises(ValueError, match="requires range_finder='gram'"):
        dist._resolve_gram_projection("gram", "direct", False, "cpu")


def _jax_model_omega(seed, x, k):
    """The Ω a JAX model's first fit draws (key split, then normal)."""
    n, d = x.shape
    _, sub = jax.random.split(jax_rng.key_from_seed(seed))
    return np.array(jax_rng.normal(sub, (d, min(k + 10, n, d)), x.dtype))


def _inject(monkeypatch, omega):
    def fake_normal(gen, shape, dtype, device):
        assert tuple(shape) == omega.shape
        return torch.from_numpy(omega).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_rng, "normal", fake_normal)


_MODELS = [
    {},  # the CPU autos: direct finder, LU, explicit centering, QR
    {"range_finder": "gram", "gram_projection": "data"},
    {"range_finder": "gram", "gram_projection": "gram"},
    {"power_iteration_normalizer": "cholqr2", "n_power_iters": 3},
]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("knobs", _MODELS, ids=lambda kw: str(sorted(kw)))
def test_models_at_injected_omega(monkeypatch, dtype, knobs):
    x = _data(300, 24, dtype)
    k, seed = 4, 2024
    jm = JaxRandomizedPca(k, seed=seed, **knobs)
    _inject(monkeypatch, _jax_model_omega(seed, x, k))
    pm = pt.RandomizedPca(k, seed=seed, device="cpu", **knobs)
    band = BAND[dtype]
    y_j = np.asarray(jm.fit_transform(x))
    y = pm.fit_transform(x).numpy()
    assert _relmax(y, y_j) < band
    assert _relmax(pm.singular_values_, jm.singular_values_) < band
    assert _relmax(pm.components_, jm.components_) < band
    assert _relmax(pm.mean_, jm.mean_) < band
    assert _relmax(pm.explained_variance_ratio_,
                   jm.explained_variance_ratio_) < band
    assert _relmax(pm.explained_variance_, jm.explained_variance_) < band
    assert _relmax(pm.transform(x), jm.transform(x)) < band
    assert _relmax(pm.inverse_transform(y), jm.inverse_transform(y_j)) < band


def test_builder_mirrors_constructor(monkeypatch):
    x = _data(300, 24, np.float64)
    omega = _jax_model_omega(5, x, 3)
    _inject(monkeypatch, omega)
    a = (pt.RandomizedPcaBuilder(3).seed(5).n_oversamples(10)
         .n_power_iters(7).power_iteration_normalizer("qr").centering(True)
         .range_finder("direct").finder_precision("full")
         .gram_precision("auto").gram_projection("auto").device("cpu")
         .build().fit(x))
    jm = (JaxBuilder(3).seed(5).power_iteration_normalizer("qr")
          .range_finder("direct").build().fit(x))
    assert a.device == torch.device("cpu")
    assert _relmax(a.components_, jm.components_) < 1e-10


def _err(fn):
    with pytest.raises(Exception) as info:
        fn()
    return info.value


def test_errors_match_jax():
    x = _data(30, 5, np.float64)
    pairs = [
        (lambda: pt.RandomizedPca(6, seed=0, device="cpu").fit(x),
         lambda: JaxRandomizedPca(6, seed=0).fit(x)),
        (lambda: pt.RandomizedPca(2, seed=0, device="cpu").transform(x),
         lambda: JaxRandomizedPca(2, seed=0).transform(x)),
        (lambda: pt.RandomizedPca(2, seed=0, device="cpu").fit(x)
         .transform(x[:, :4]),
         lambda: JaxRandomizedPca(2, seed=0).fit(x).transform(x[:, :4])),
        (lambda: pt.RandomizedPca(2, seed=0, device="cpu").fit(x)
         .inverse_transform(np.ones((3, 3))),
         lambda: JaxRandomizedPca(2, seed=0).fit(x)
         .inverse_transform(np.ones((3, 3)))),
        (lambda: pt.RandomizedPca(2, seed=0, device="cpu").fit(x[0]),
         lambda: JaxRandomizedPca(2, seed=0).fit(x[0])),
        (lambda: pt.RandomizedPca(-1), lambda: JaxRandomizedPca(-1)),
        (lambda: pt.RandomizedPca(2, seed=0, device="cpu")
         .explained_variance_ratio(),
         lambda: JaxRandomizedPca(2, seed=0).explained_variance_ratio()),
    ]
    for port_call, jax_call in pairs:
        e, e_j = _err(port_call), _err(jax_call)
        assert isinstance(e, pt.InvalidInput)
        assert type(e).__name__ == type(e_j).__name__
        assert str(e) == str(e_j)
    for bad in ({"range_finder": "x"}, {"gram_precision": "x"},
                {"gram_projection": "x"}, {"finder_precision": "x"},
                {"power_iteration_normalizer": "x"}):
        with pytest.raises(ValueError):
            pt.RandomizedPca(2, seed=0, device="cpu", **bad)
    # A mesh is ported (tests/test_torch_sharding.py): a mesh fit runs.
    # A non-mesh object builds and fails at fit with AttributeError, as
    # in the JAX package.
    from petal_decomposition_tpu_torch.parallel import make_mesh

    x = _data(40, 6, np.float64)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    meshed = pt.RandomizedPca(2, seed=0, mesh=mesh).fit(x)
    assert tuple(meshed.components_.shape) == (2, 6)
    assert meshed.device == torch.device("cpu")
    for build in (lambda: pt.RandomizedPca(2, seed=0, device="cpu",
                                           mesh=object()),
                  pt.RandomizedPcaBuilder(2).mesh(object()).build,
                  lambda: JaxRandomizedPca(2, seed=0, mesh=object()),
                  JaxBuilder(2).mesh(object()).build):
        with pytest.raises(AttributeError, match="devices"):
            build().fit(x)


def test_linalg_error_leaves_fitted_state(monkeypatch):
    """``LinalgError`` is raised before any state is installed."""
    x = _data(200, 12, np.float64)
    m = pt.RandomizedPca(3, seed=1, device="cpu").fit(x)
    before = {k: v.clone() for k, v in (
        ("components", m.components_), ("mean", m.mean_),
        ("sigma", m.singular_values_),
    )}
    monkeypatch.setattr(pt.config, "jacobi_max_sweeps", 1)
    with pytest.raises(pt.LinalgError, match="did not converge"):
        m.fit(_data(150, 12, np.float64, seed=3) * 7)
    assert m._n_samples == 200
    assert torch.equal(m.components_, before["components"])
    assert torch.equal(m.mean_, before["mean"])
    assert torch.equal(m.singular_values_, before["sigma"])


def test_seeded_stream(monkeypatch):
    """One seed, one stream; each fit advances it; every 32-bit limb of
    a u128 seed participates."""
    drawn = []
    real = port_rng.normal

    def spy(gen, shape, dtype, device):
        out = real(gen, shape, dtype, device)
        drawn.append(out.clone())
        return out

    monkeypatch.setattr(port_rng, "normal", spy)
    x = _data(120, 10, np.float64)
    seed = (7 << 96) | 12345
    a = pt.RandomizedPca(3, seed=seed, device="cpu")
    a.fit(x)
    a.fit(x)
    pt.RandomizedPca(3, seed=seed, device="cpu").fit(x)
    pt.RandomizedPca(3, seed=seed ^ (1 << 100), device="cpu").fit(x)
    pt.RandomizedPcaBuilder.with_generator(
        port_rng.generator_from_seed(seed), 3).device("cpu").build().fit(x)
    first, second, again, other, from_generator = drawn
    assert torch.equal(first, again)
    assert torch.equal(first, from_generator)
    assert not torch.equal(first, second)
    assert not torch.equal(first, other)
    b = pt.RandomizedPca(3, seed=seed, device="cpu")
    np.testing.assert_array_equal(b.fit(x).singular_values_.numpy(),
                                  pt.RandomizedPca(3, seed=seed, device="cpu")
                                  .fit(x).singular_values_.numpy())


def test_fit_stats_and_trace(tmp_path):
    from petal_decomposition_tpu_torch.utils.profiling import trace

    x = _data(120, 10, np.float64)
    with trace(str(tmp_path)):
        m = pt.RandomizedPca(3, seed=1, device="cpu").fit(x)
    stats = m.last_fit_stats_
    assert (stats.n_samples, stats.n_features) == (120, 10)
    assert stats.wall_time_s > 0
    assert (tmp_path / "trace.json").stat().st_size > 0


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_state_carried_from_jax_model(dtype):
    x = _data(250, 16, dtype)
    jm = JaxRandomizedPca(4, seed=3).fit(x)
    state = {
        "components_": np.asarray(jm.components_),
        "mean_": np.asarray(jm.mean_),
        "singular_values_": np.asarray(jm.singular_values_),
        "_singular_full": np.asarray(jm._singular_full),
        "_total_variance": np.asarray(jm._total_variance),
        "_n_samples": jm._n_samples,
        "n_components": jm.n_components(),
        "centering": jm._centering,
    }
    pm = randomized_pca_from_numpy(state, "cpu")
    band = BAND[dtype]
    y_j = np.asarray(jm.transform(x))
    assert _relmax(pm.transform(x), y_j) < band
    assert _relmax(pm.inverse_transform(y_j),
                   jm.inverse_transform(y_j)) < band
    assert _relmax(pm.explained_variance_ratio_,
                   jm.explained_variance_ratio_) < band
    assert pm.n_components() == 4 and pm._n_samples == 250


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_route_on_card(cuda_device):
    """The slice on the card launches K1 and K2 and agrees with the CPU
    port's kernel-free run at the same seed."""
    from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels

    x = _data(70_000, 64, np.float32)
    k1.launches = jacobi_kernels.launches = 0
    m = (pt.RandomizedPcaBuilder(6).seed(9).range_finder("gram")
         .gram_projection("data").device(cuda_device).build().fit(x))
    assert k1.launches == 1 and jacobi_kernels.launches == 1
    ref = (pt.RandomizedPcaBuilder(6).seed(9).range_finder("gram")
           .gram_projection("data").device("cpu").build().fit(x))
    assert _relmax(m.singular_values_.cpu(), ref.singular_values_) < 1e-4
