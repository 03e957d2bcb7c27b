"""Exact ``Pca`` of the port against the JAX package's ``Pca``: the
cases of tests/test_pca.py (ports of the reference's pca.rs:852-1051),
BASELINE config 1, the QR-preconditioned rung, the Gram solver, state
carried across, and (on a CUDA card) the kernels the fits launch."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.parallel.distributed import (
    pca_fit_gram as jax_pca_fit_gram,
)
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch import config
from petal_decomposition_tpu_torch.models.pca import Pca as PortPca
from petal_decomposition_tpu_torch.ops import jacobi
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2
from petal_decomposition_tpu_torch.parallel.distributed import pca_fit_gram
from petal_decomposition_tpu_torch.utils.convert import pca_from_numpy

BAND = {np.float64: 1e-10, np.float32: 1e-5}
GOLDEN = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])


def _port(k, **kw):
    return pt.Pca(k, device="cpu", **kw)


def _rel(got, want):
    got = np.asarray(got)
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _assert_same(x, k, band, **kw):
    """fit_transform, fit + transform, inverse_transform, components,
    mean, σ and explained variance of the port's Pca against the JAX
    package's, within ``band`` relative to each output's scale."""
    mj = jpd.Pca(k, **kw)
    yj = np.asarray(mj.fit_transform(x))
    m = _port(k, **kw)
    y = m.fit_transform(x).numpy()
    assert y.dtype == yj.dtype and y.shape == yj.shape
    if y.size:
        assert _rel(y, yj) < band
        assert _rel(m.transform(x).numpy(), yj) < band
        assert _rel(m.inverse_transform(y).numpy(),
                    np.asarray(mj.inverse_transform(yj))) < band
        assert _rel(m.components_.numpy(), np.asarray(mj.components_)) < band
        assert _rel(m.singular_values_.numpy(),
                    np.asarray(mj.singular_values_)) < band
        assert _rel(m.explained_variance_ratio_.numpy(),
                    np.asarray(mj.explained_variance_ratio_)) < band
        assert _rel(m.explained_variance_.numpy(),
                    np.asarray(mj.explained_variance_)) < band
    assert _rel(m.mean_.numpy(), np.asarray(mj.mean_)) < band
    return m, mj


def _low_rank(n, d, seed=0):
    """A float32 feature table like the smoke run's: σⱼ ∝ 3·0.9ʲ over 32
    directions above a flat noise floor of 0.05, mean 0.1 a column."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, 32)))[0]
    x = 0.05 * rng.standard_normal((n, d))
    x += (rng.standard_normal((n, 32)) * 3.0 * 0.9 ** np.arange(32)) @ basis.T
    return (x + 0.1 * rng.standard_normal(d)).astype(np.float32)


def _gaussian(n, d, dtype=np.float64, seed=0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) + offset).astype(dtype)


def _decaying(n, d, dtype=np.float32, seed=0, offset=0.5):
    """σⱼ ∝ 0.7ʲ in a random basis: float32 singular vectors are then
    well conditioned, so two float32 SVDs agree at the 1e-5 band (on a
    Gaussian panel their gaps put eps/gap above it)."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d)))[0]
    x = (rng.standard_normal((n, d)) * 0.7 ** np.arange(d)) @ basis.T
    return (10 * x + offset).astype(dtype)


@pytest.mark.parametrize(
    "name,x,k,kw",
    [
        ("numpy_reference", _gaussian(200, 32, seed=42), 5, {}),
        ("golden", GOLDEN, 1, {}),
        ("no_centering", GOLDEN, 1, {"centering": False}),
        ("evr", np.array([[-1.0, -1.0], [-2.0, -1.0], [-3.0, -2.0],
                          [1.0, 1.0], [2.0, 1.0], [3.0, 2.0]]), 2, {}),
        ("f32", _decaying(60, 10, seed=1), 4, {}),
        ("f32_wide", _decaying(30, 12, seed=2).T.copy(), 6, {}),
        ("wide_f64", _gaussian(7, 12, seed=3), 6, {}),  # rank 6 centered
        ("rank_deficient_centered", _gaussian(5, 9, seed=17), 3, {}),
        ("integer_upcast",
         np.random.default_rng(7).integers(-9, 10, size=(8, 3)), 2, {}),
        ("gram_wide", _gaussian(10, 25, seed=9), 4, {"solver": "gram"}),
        ("gram_tall", _gaussian(300, 12, seed=4, offset=3.0), 6,
         {"solver": "gram"}),
        ("gram_f32", _decaying(300, 12, seed=5), 6,
         {"solver": "gram"}),
        # BASELINE config 1: exact PCA of 1000×64 f64 Gaussian data.
        ("baseline_config1", _gaussian(1000, 64, seed=2024), 64, {}),
    ],
)
def test_matches_jax(name, x, k, kw):
    band = BAND[np.float32 if x.dtype == np.float32 else np.float64]
    _assert_same(x, k, band, **kw)


def test_tall_f64_takes_the_qr_preconditioned_rung():
    """m·n ≥ 2²⁰ and m ≥ 3n: both packages QR-precondition the plain
    Jacobi core off the card (jacobi.py:385-396)."""
    from petal_decomposition_tpu_torch.ops.jacobi import _route

    rng = np.random.default_rng(6)
    x = rng.standard_normal((16384, 64)) @ np.diag(np.linspace(1, 4, 64))
    assert _route(16384, 64, torch.float64, "cpu") == "qr_plain"
    _assert_same(x + 1.0, 8, 1e-10)


def test_zero_components_and_single_sample():
    """ref: pca.rs:862-883."""
    pca = pt.PcaBuilder(0).device("cpu").build()
    assert pca.fit_transform(np.zeros((0, 5), np.float32)).shape == (0, 0)
    y = pca.fit_transform(GOLDEN.astype(np.float32))
    assert tuple(y.shape) == (3, 0)
    y = _port(1).fit_transform(np.array([[1.0, 1.0]], np.float32))
    np.testing.assert_array_equal(y.numpy(), [[0.0]])
    np.testing.assert_array_equal(
        y.numpy(),
        np.asarray(jpd.Pca(1).fit_transform(np.array([[1.0, 1.0]],
                                                     np.float32))),
    )


def test_golden_values():
    """ref: pca.rs:885-916 — the collinear matrix."""
    pca = _port(1)
    y = pca.fit_transform(GOLDEN).numpy()
    np.testing.assert_allclose(np.abs(y[:, 0]), [5.0, 0.0, 5.0], atol=1e-10)
    assert np.abs(pca.inverse_transform(y).numpy() - GOLDEN).max() < 1e-10
    assert np.abs(_port(1).fit(GOLDEN).components().numpy()
                  - [[-0.6, -0.8]]).max() < 1e-10
    nc = pt.PcaBuilder(1).centering(False).device("cpu").build()
    y = nc.fit_transform(GOLDEN).numpy()
    np.testing.assert_allclose(np.abs(y[:, 0]), [0.0, 5.0, 10.0], atol=1e-10)
    np.testing.assert_array_equal(nc.mean().numpy(), [0.0, 0.0])
    ratio = _port(2).fit(np.array([[-1.0, -1.0], [-2.0, -1.0], [-3.0, -2.0],
                                   [1.0, 1.0], [2.0, 1.0], [3.0, 2.0]])
                         ).explained_variance_ratio().numpy()
    assert ratio[0] > 0.99244 and ratio[1] < 0.00756


def _error(fn):
    with pytest.raises(Exception) as err:
        fn()
    return type(err.value).__name__, str(err.value)


@pytest.mark.parametrize(
    "case",
    ["dims", "transform_cols", "inverse_cols", "unfitted"],
)
def test_errors_match_jax(case):
    """The three wrong-shape errors (pca.rs:199-204, 736-741, 798-803)
    and transform-before-fit raise the JAX package's class and message."""
    def run(make):
        if case == "dims":
            return _error(lambda: make(3).fit(np.zeros((2, 2))))
        if case == "unfitted":
            return _error(lambda: make(1).transform(GOLDEN))
        model = make(1)
        model.fit(GOLDEN)
        if case == "transform_cols":
            return _error(lambda: model.transform(np.zeros((3, 5))))
        return _error(lambda: model.inverse_transform(np.zeros((3, 2))))

    assert run(_port) == run(jpd.Pca)
    assert run(_port)[0] == "InvalidInput"


def test_integer_input_upcasts():
    """Centered, this input has rank 1: the second component is any
    unit vector orthogonal to the first, so only the upcast and
    finiteness are the JAX package's contract here."""
    y = _port(2).fit_transform(np.arange(24).reshape(8, 3))
    assert y.dtype == torch.float64 and bool(torch.isfinite(y).all())


def test_fit_transform_equals_fit_then_transform():
    x = _gaussian(50, 7)
    y1 = _port(3).fit_transform(x).numpy()
    y2 = _port(3).fit(x).transform(x).numpy()
    assert np.abs(y1 - y2).max() < 1e-10


def test_complex():
    """Complex input goes through torch.linalg (LAPACK here, as the JAX
    package's CPU placement); singular vectors are unique only up to a
    phase, so compare what is phase-free."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((30, 6)) + 1j * rng.standard_normal((30, 6))
    mj = jpd.Pca(2)
    yj = np.asarray(mj.fit_transform(x))
    m = _port(2)
    y = m.fit_transform(x).numpy()
    assert y.dtype == np.complex128 and y.shape == (30, 2)
    assert _rel(m.singular_values_.numpy(), np.asarray(mj.singular_values_)
                ) < 1e-10
    assert _rel(m.explained_variance_ratio_.numpy(),
                np.asarray(mj.explained_variance_ratio_)) < 1e-10
    assert _rel(np.abs(y), np.abs(yj)) < 1e-10
    w, wj = m.components_.numpy(), np.asarray(mj.components_)
    assert _rel(w.conj().T @ w, wj.conj().T @ wj) < 1e-10  # projector
    assert np.abs(m.transform(x).numpy() - y).max() < 1e-10
    back = m.inverse_transform(y).numpy()
    assert _rel(back, np.asarray(mj.inverse_transform(yj))) < 1e-10


def test_gram_solver_agrees_with_full():
    x = _gaussian(10, 25, seed=9)
    y_g = _port(4, solver="gram").fit_transform(x).numpy()
    y_f = _port(4, solver="full").fit_transform(x).numpy()
    np.testing.assert_allclose(y_g, y_f, atol=1e-7)


@pytest.mark.parametrize("offset", [500.0, 3.0])
def test_gram_mean_dominated_sigma(offset):
    """The fused XᵀX − n·μμᵀ cancels on mean-dominated data; past
    ``_SQNORM_GUARD_RMAX`` (offset 500: r ≈ 7e3 > 30) it is rebuilt from
    an explicitly centered copy, as the JAX package's in-graph guard
    does; below it (offset 3: r ≈ 16) the fused Gram stands."""
    rng = np.random.default_rng(3)
    x = ((rng.standard_normal((2000, 64)) @ np.diag(np.linspace(1, 10, 64)))
         + offset).astype(np.float32)
    st = pca_fit_gram(torch.from_numpy(x))
    st_j = jax_pca_fit_gram(jnp.asarray(x), fuse_centering=True,
                            cfg=("torch-port-gram-guard",))
    x64 = x.astype(np.float64)
    s_ref = np.linalg.svd(x64 - x64.mean(0), compute_uv=False)
    s = st["sigma"].numpy()[:8]
    assert np.max(np.abs(s - s_ref[:8]) / s_ref[:8]) < 1e-4
    assert _rel(s, np.asarray(st_j["sigma"])[:8]) < 1e-5
    assert float(st["off"]) == 0.0  # LAPACK: no certificate


def test_state_from_a_fitted_jax_model():
    x = _gaussian(80, 9, seed=8, offset=2.0)
    mj = jpd.PcaBuilder(4).build().fit(x)
    state = {
        "components_": np.asarray(mj.components_),
        "mean_": np.asarray(mj.mean_),
        "singular_values_": np.asarray(mj.singular_values_),
        "_singular_full": np.asarray(mj._singular_full),
        "_total_variance": np.asarray(mj._total_variance),
        "_n_samples": mj._n_samples,
        "n_components": mj.n_components(),
        "centering": mj._centering,
    }
    m = pca_from_numpy(state, "cpu")
    assert isinstance(m, PortPca) and m.n_components() == 4
    y = m.transform(x).numpy()
    assert _rel(y, np.asarray(mj.transform(x))) < 1e-12
    assert _rel(m.inverse_transform(y).numpy(),
                np.asarray(mj.inverse_transform(y))) < 1e-12
    assert _rel(m.explained_variance_ratio_.numpy(),
                np.asarray(mj.explained_variance_ratio_)) < 1e-12


def test_failed_refit_leaves_the_model_untouched(monkeypatch):
    x = _gaussian(40, 8, seed=11)
    m = _port(3).fit(x)
    before = m.components_.clone()
    monkeypatch.setattr(config, "jacobi_max_sweeps", 1)
    with pytest.raises(pt.LinalgError):
        m.fit(_gaussian(40, 8, seed=12))
    assert torch.equal(m.components_, before)


def test_unported_surfaces_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        pt.PcaBuilder(2).mesh(object()).build()
    m = _port(2)
    for call in (m.fit_batched, m.partial_fit, m.transform_batched):
        with pytest.raises(NotImplementedError, match="item 6"):
            call([GOLDEN])
    with pytest.raises(ValueError, match="solver"):
        _port(2, solver="qdwh")
    with pytest.raises(pt.InvalidInput):
        _port(-1)


@pytest.mark.parametrize(
    "shape,dtype,gram",
    [
        ((100_000, 632), torch.float32, False),  # K2 takes the 632² R
        ((100_000, 634), torch.float32, True),   # beyond K2: the Gram
        ((1_000, 634), torch.float32, False),    # n < 8d
        ((100_000, 700), torch.float64, False),  # never float64
        ((100_000, 700), torch.complex64, False),
    ],
)
def test_auto_prefers_gram_on_the_card(shape, dtype, gram):
    """The CUDA decision, read from a ``meta`` tensor: neither the
    device nor the data is needed."""
    x = torch.empty(shape, dtype=dtype, device="meta")
    assert PortPca._auto_prefers_gram(x) is gram
    assert not PortPca._auto_prefers_gram(torch.empty((10, 2)))  # CPU


def _jax_prefers_gram(n, d):
    """The JAX package's rule (``models/pca.py:_auto_prefers_gram``) on an
    accelerator, for float32, with its own kernel gate; its backend test
    is the one thing left out, since the JAX here runs on the CPU."""
    from petal_decomposition_tpu.ops.pallas import jacobi_kernels as jk

    direct_ok = jk.supports(n, d, np.float32)
    qr_precond_ok = jk.supports(d + (d % 2), d, np.float32)
    return not (direct_ok or qr_precond_ok) and n >= 8 * d


def _count_k2_block_plain(monkeypatch):
    """Record the shape of each panel K2's block plain version gets."""
    calls = []
    real = k2._jacobi_svd_block_plain

    def counted(a, max_sweeps, w):
        calls.append(tuple(a.shape))
        return real(a, max_sweeps, w)

    monkeypatch.setattr(k2, "_jacobi_svd_block_plain", counted)
    return calls


def test_qr_k2_route_matches_jax_pca_at_256(monkeypatch):
    """Exact float32 Pca through the rung the card takes for a table of
    256 columns (QR + K2 on the R, forced here on the CPU, where K2's
    wrapper runs its block plain version) against the JAX package's Pca
    at the float32 band.  The table is 4000×64 and not 256 wide, as the
    test's name still says: its 64×64 R is the narrowest whose plan pairs
    blocks across CTAs as the 256×256 R's does (P ≥ 2), and the block
    plain version takes minutes on a 256×256 R."""
    calls = _count_k2_block_plain(monkeypatch)
    monkeypatch.setattr(config, "linalg_backend", "jacobi")
    monkeypatch.setattr(jacobi, "_route", lambda m, n, dtype, dev: "qr_k2")
    assert k2.plan(256, 256)[1] >= 2 and k2.plan(64, 64)[1] >= 2
    x = _low_rank(4000, 64, seed=25)
    m, _ = _assert_same(x, 8, BAND[np.float32])
    assert calls == [(64, 64)]
    assert m.singular_values_.dtype == torch.float32


@pytest.mark.parametrize("rung", ["k2", "qr_k2"])
def test_k2_direct_where_the_jax_gate_takes_qr_k2(monkeypatch, rung):
    """Both sides of the JAX kernel's gate (m·max(n_pad, 128) ≤ 400k) at
    16 columns: the 3125×16 float32 panel, the tallest the gate admits,
    goes to K2 directly, and 10000×16 (1.28M) to QR + K2 on its R, on the
    card's ladder as in the JAX package.  Each rung, forced on the CPU
    through K2's block plain version, gives the JAX package's Pca at the
    float32 band."""
    from petal_decomposition_tpu.ops.pallas import jacobi_kernels as jk

    m = 3125 if rung == "k2" else 10_000
    assert bool(jk.supports(m, 16, np.float32)) is (rung == "k2")
    assert k2.supports(m, 16, torch.float32) is (rung == "k2")
    assert jacobi._route(m, 16, torch.float32, "cuda") == rung
    calls = _count_k2_block_plain(monkeypatch)
    monkeypatch.setattr(config, "linalg_backend", "jacobi")
    monkeypatch.setattr(jacobi, "_route", lambda m_, n_, dtype, dev: rung)
    x = _decaying(m, 16, seed=26)
    _assert_same(x, 8, BAND[np.float32])
    assert calls == [(m, 16) if rung == "k2" else (16, 16)]


def test_direct_k2_is_the_jax_gate():
    """Over a grid of float32 panels the ladder hands K2 directly exactly
    the panels the JAX kernel's gate takes directly."""
    from petal_decomposition_tpu.ops.pallas import jacobi_kernels as jk

    for n in (2, 16, 43, 64, 127, 128, 169, 300, 632):
        for m in sorted({n, 1024, 3124, 3125, 3126, 5000, 10_000, 28_924,
                         100_000}):
            if m >= n:
                gate = bool(jk.supports(m, n, np.float32))
                assert k2.supports(m, n, torch.float32) is gate, (m, n)
                assert (jacobi._route(m, n, torch.float32, "cuda")
                        == ("k2" if gate else "qr_k2")), (m, n)


def test_auto_prefers_gram_follows_the_jax_package():
    """On the card the port sends every float32 shape where the JAX
    package sends it: the Gram route only past K2's 632² R, at n ≥ 8d."""
    ds = sorted(set(range(1, 80)) | set(range(80, 1400, 13))
                | {168, 169, 630, 631, 632, 633, 634, 4096})
    for d in ds:
        for n in sorted({1, d - 1, d, 3 * d, 8 * d - 1, 8 * d, 8 * d + 1,
                         3125, 3126, 28_924, 100_000, 1_000_000} - {0}):
            x = torch.empty((n, d), dtype=torch.float32, device="meta")
            assert PortPca._auto_prefers_gram(x) is _jax_prefers_gram(n, d), (
                n, d)


def test_record_fit_and_builder():
    m = pt.PcaBuilder.new(2).centering(True).solver("full").device(
        "cpu").build()
    m.fit(_gaussian(30, 5))
    st = m.last_fit_stats_
    assert (st.n_samples, st.n_features) == (30, 5)
    assert st.wall_time_s > 0
    assert m.device == torch.device("cpu")
    assert pt.Pca.new(2).n_components() == 2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,solver",
    [((1000, 64), "full"), ((20_000, 64), "full"), ((3000, 64), "gram")],
)
def test_f64_fit_launches_k3_on_card(cuda_device, shape, solver):
    """Direct K3, QR + K3 on R, and K3 as the Gram's eigensolver; the
    result agrees with the CPU fit at the float64 band."""
    x = _gaussian(*shape, seed=21, offset=1.0)
    before = k3.launches
    m = pt.Pca(8, device=cuda_device, solver=solver)
    y = m.fit_transform(x).cpu().numpy()
    assert k3.launches == before + 1
    y_cpu = _port(8, solver=solver).fit_transform(x).numpy()
    assert _rel(y, y_cpu) < (1e-10 if solver == "full" else 1e-8)


@pytest.mark.cuda
def test_f32_fit_launches_k2_through_the_tall_route(cuda_device):
    x = _decaying(20_000, 64, seed=22)
    assert not k2.supports(20_000, 64, torch.float32)
    before = k2.launches
    m = pt.Pca(8, device=cuda_device)
    y = m.fit_transform(x).cpu().numpy()
    assert k2.launches == before + 1
    y_cpu = _port(8).fit_transform(x).numpy()
    assert _rel(y, y_cpu) < 1e-5


@pytest.mark.cuda
def test_wide_f32_fit_runs_qr_and_k2_on_card(cuda_device):
    """Exact float32 Pca of a 200,000 × 256 table on the default solver:
    QR + K2 on the 256×256 R (the JAX package's route), one launch, σ
    within 1e-5 of float64 LAPACK on the card."""
    x = _low_rank(200_000, 256, seed=24)
    assert not PortPca._auto_prefers_gram(
        torch.empty(x.shape, dtype=torch.float32, device="meta"))
    before = k2.launches
    m = pt.Pca(16, device=cuda_device)
    m.fit(x)
    assert k2.launches == before + 1
    x64 = torch.from_numpy(x).to(cuda_device).double()
    s_ref = torch.linalg.svdvals(x64 - x64.mean(0))[:16]
    s = m.singular_values_.double()
    assert float(((s - s_ref).abs() / s_ref).max()) < 1e-5
