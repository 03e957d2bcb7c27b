"""The JAX package's behavioural RandomizedPca cases (tests/
test_randomized_pca.py, test_gram_finder.py, test_gram_projection.py —
ports of the reference's pca.rs:949-1041), run on the PyTorch port.
Exact PCA is not ported yet, so numpy's SVD of the centered data is the
exact oracle."""

import numpy as np
import pytest
import torch

from petal_decomposition_tpu_torch import (
    InvalidInput,
    RandomizedPca,
    RandomizedPcaBuilder,
)
from petal_decomposition_tpu_torch.parallel.distributed import (
    randomized_pca_fit,
)
from petal_decomposition_tpu_torch.utils import rng as port_rng

RNG_SEED = 1_234_567_891_011_121_314  # ref: pca.rs:860
CPU = "cpu"


def _rpca(k, **kw):
    return RandomizedPca(k, device=CPU, **kw)


def _exact_sigma(x, k, centering=True):
    x = np.asarray(x, np.float64)
    if centering:
        x = x - x.mean(0)
    return np.linalg.svd(x, compute_uv=False)[:k]


def _np(t):
    return t.numpy()


def test_golden():
    """ref: pca.rs:950-970 — collinear matrix projects to ±5/0."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    pca = _rpca(1, seed=RNG_SEED)
    assert pca.n_components() == 1
    y = _np(pca.fit(x).transform(x))
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10
    assert abs(abs(y[2, 0]) - 5.0) < 1e-10
    assert np.abs(_np(pca.inverse_transform(y)) - x).max() < 1e-10
    y = _np(_rpca(1).fit_transform(x))  # random seed
    assert abs(abs(y[0, 0]) - 5.0) < 1e-10
    assert abs(y[1, 0]) < 1e-10


def test_explained_variance_ratio():
    """ref: pca.rs:973-987."""
    x = np.array([[-1.0, -1.0], [-2.0, -1.0], [-3.0, -2.0],
                  [1.0, 1.0], [2.0, 1.0], [3.0, 2.0]])
    ratio = _np(_rpca(2).fit(x).explained_variance_ratio())
    assert ratio[0] > 0.99244
    assert ratio[1] < 0.00756


def test_randomized_vs_exact_equivalence():
    """ref: pca.rs:989-1027 — 5% relative agreement on 100×80 Gaussian."""
    x = np.random.default_rng(RNG_SEED % 2**63).standard_normal((100, 80))
    m = _rpca(2, seed=RNG_SEED).fit(x)
    s_exact = _exact_sigma(x, 2)
    tv = ((x - x.mean(0)) ** 2).sum()
    np.testing.assert_allclose(_np(m.singular_values()), s_exact, rtol=0.05)
    np.testing.assert_allclose(_np(m.explained_variance_ratio()),
                               s_exact ** 2 / tv, rtol=0.05)


@pytest.mark.parametrize("normalizer", ["lu", "qr", "cholqr2", "none"])
def test_power_iteration_normalizers(normalizer):
    """All normalizers recover a low-rank spectrum accurately."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((300, 4)) @ np.diag([100.0, 50.0, 20.0, 10.0])
    x = x @ rng.standard_normal((4, 50)) + 0.01 * rng.standard_normal(
        (300, 50))
    n_iters = 7 if normalizer != "none" else 2  # unnormalized overflows
    m = (RandomizedPcaBuilder(4).seed(RNG_SEED).device(CPU)
         .power_iteration_normalizer(normalizer).n_power_iters(n_iters)
         .build().fit(x))
    np.testing.assert_allclose(_np(m.singular_values()),
                               _exact_sigma(x, 4), rtol=1e-6)


def test_deterministic_given_seed():
    x = np.random.default_rng(0).standard_normal((40, 20))
    y1 = _np(_rpca(3, seed=RNG_SEED).fit_transform(x))
    y2 = _np(_rpca(3, seed=RNG_SEED).fit_transform(x))
    np.testing.assert_array_equal(y1, y2)


def test_fit_transform_equals_fit_then_transform():
    x = np.random.default_rng(5).standard_normal((60, 12))
    y1 = _np(_rpca(4, seed=RNG_SEED).fit_transform(x))
    y2 = _np(_rpca(4, seed=RNG_SEED).fit(x).transform(x))
    assert np.abs(y1 - y2).max() < 1e-9


def test_invalid_dims_and_oversampling_cap():
    with pytest.raises(InvalidInput):
        _rpca(5).fit(np.zeros((3, 3)))
    # k + 10 > min(m, n): oversampling caps (pca.rs:707-716).
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    assert _rpca(2, seed=RNG_SEED).fit(x).singular_values().shape == (2,)


def test_without_centering():
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    y = _np(RandomizedPcaBuilder(1).seed(RNG_SEED).centering(False)
            .device(CPU).build().fit_transform(x))
    np.testing.assert_allclose(np.abs(y[:, 0]), [0.0, 5.0, 10.0],
                               atol=1e-10)


def test_empty_input_and_single_sample():
    """0 rows with k > 0 violates every-dim ≥ k (pca.rs:513-517); with
    k = 0 the fit returns early (pca.rs:519-528)."""
    x = np.zeros((0, 4))
    with pytest.raises(InvalidInput):
        _rpca(2, seed=RNG_SEED).fit(x)
    assert _rpca(0, seed=RNG_SEED).fit_transform(x).shape[0] == 0
    y = _np(_rpca(1, seed=RNG_SEED).fit_transform(
        np.array([[1.0, 2.0, 3.0]])))
    assert y.shape == (1, 1) and np.all(np.isfinite(y))


def test_complex_input_is_not_ported():
    """Complex input is ported to the in-core fit (its parity is in
    ``test_torch_complex_randomized.py``); the streamed fits reject it,
    as the JAX package's do."""
    x = (np.arange(30.0).reshape(10, 3) % 7) * (1 + 0.5j)
    assert _rpca(2, seed=1).fit_transform(x).dtype == torch.complex128
    with pytest.raises(InvalidInput, match="real dtypes only"):
        _rpca(2, seed=1).fit_batched([x])


def _decaying(n=2000, d=96, seed=21, offset=0.5):
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((n, d)))
    v, _ = np.linalg.qr(rng.standard_normal((d, d)))
    return (u * np.logspace(0, -4, d)) @ v.T + offset


def test_mixed_precision_finder_accuracy():
    """finder_precision='f32': σ from the f64 projection match the full
    f64 pipeline and the exact SVD to ~1e-9 relative."""
    x = _decaying()
    k = 8
    full = (RandomizedPcaBuilder(k).seed(RNG_SEED).finder_precision("full")
            .device(CPU).build().fit(x))
    mixed = (RandomizedPcaBuilder(k).seed(RNG_SEED).finder_precision("f32")
             .device(CPU).build().fit(x))
    s_f, s_m = _np(full.singular_values()), _np(mixed.singular_values())
    assert np.abs(s_m / s_f - 1).max() < 1e-9
    assert np.abs(s_m / _exact_sigma(x, k) - 1).max() < 1e-9
    np.testing.assert_allclose(_np(mixed.components()),
                               _np(full.components()), atol=5e-5)
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]])
    y = _np(_rpca(1, seed=RNG_SEED, finder_precision="f32").fit_transform(x))
    np.testing.assert_allclose(np.abs(y[:, 0]), [5.0, 0.0, 5.0], atol=1e-8)


def test_rank_deficient_channels():
    """3 sources on 6 channels: every normalizer gives finite factors
    (CholeskyQR2 needs its escalating shift here)."""
    rng = np.random.default_rng(0)
    n = 20_000
    t = np.linspace(0, 8, n)
    sources = np.stack(
        [np.sign(np.sin(3 * t)), 2 * (t % 1) - 1,
         np.sign(rng.standard_normal(n)) * rng.standard_normal(n) ** 2],
        axis=1,
    )
    x = sources @ rng.standard_normal((3, 6))
    for norm in ("lu", "qr", "cholqr2"):
        m = (RandomizedPcaBuilder(3).seed(42).power_iteration_normalizer(norm)
             .device(CPU).build())
        y = _np(m.fit_transform(x))
        evr = _np(m.explained_variance_ratio())
        assert np.all(np.isfinite(y)) and np.all(np.isfinite(evr)), norm
        assert evr.sum() > 0.99


@pytest.mark.parametrize("final_orth", ["qr", "cholqr2"])
def test_single_sample_all_orth_paths(final_orth):
    """1 sample: centering makes the panel exactly zero; σ = 0 and all
    factors finite."""
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0, 5.0]], dtype=torch.float64)
    omega = port_rng.normal(port_rng.generator_from_seed(3), (5, 1),
                            torch.float64, CPU)
    st = randomized_pca_fit(x, omega, n_components=1, n_power_iters=2,
                            normalizer="lu", fuse_centering=False,
                            final_orth=final_orth)
    for key in ("u", "sigma", "vt"):
        assert torch.isfinite(st[key]).all(), key
    assert not st["sigma"].any()


def _spread(n=3000, d=256, dtype=np.float32, offset=0.0):
    rng = np.random.default_rng(42)
    x = rng.standard_normal((n, d)) @ np.diag(np.linspace(1, 30, d))
    return (x + offset).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_matches_direct(dtype):
    x = _spread(dtype=dtype)
    s_dir = _np(_rpca(8, seed=RNG_SEED).fit(x).singular_values_)
    s_gram = _np(_rpca(8, seed=RNG_SEED, range_finder="gram")
                 .fit(x).singular_values_)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.max(np.abs(s_dir - s_gram) / s_dir) < tol


def test_gram_transform_roundtrip_and_no_centering():
    x = _spread()
    m = _rpca(6, seed=RNG_SEED, range_finder="gram").fit(x)
    y = _np(m.transform(x))
    y2 = _np(m.transform(_np(m.inverse_transform(y))))
    assert np.allclose(y, y2, rtol=1e-4, atol=1e-3)
    s_dir = _np(_rpca(8, seed=RNG_SEED, centering=False).fit(x)
                .singular_values_)
    s_gram = _np(_rpca(8, seed=RNG_SEED, centering=False,
                       range_finder="gram").fit(x).singular_values_)
    assert np.max(np.abs(s_dir - s_gram) / s_dir) < 1e-5


@pytest.mark.parametrize("projection", ["data", "gram"])
def test_gram_mean_dominated_guard(projection):
    """r = n‖μ‖²/tr(Gc) ≫ threshold engages the explicitly centered
    recompute; σ stay at working precision."""
    x = _spread(offset=1000.0)
    s_dir = _np(_rpca(8, seed=RNG_SEED).fit(x).singular_values_)
    s = _np(_rpca(8, seed=RNG_SEED, range_finder="gram",
                  gram_projection=projection, gram_precision="default")
            .fit(x).singular_values_)
    assert np.max(np.abs(s_dir - s) / s_dir) < 1e-4


@pytest.mark.parametrize("finder", ["gram", "direct"])
def test_mean_dominated_total_variance(finder):
    """With fused centering the analytic ‖X‖² − n‖μ‖² is
    cancellation-guarded: at offset 1000 (f32, r ≈ 3e3) the guard
    recomputes the total variance explicitly."""
    x = _spread(offset=1000.0)
    tv_ref = ((x.astype(np.float64) - x.astype(np.float64).mean(0)) ** 2
              ).sum()
    omega = port_rng.normal(port_rng.generator_from_seed(RNG_SEED),
                            (256, 18), torch.float32, CPU)
    st = randomized_pca_fit(torch.from_numpy(x), omega, n_components=8,
                            normalizer="cholqr2", range_finder=finder,
                            fuse_centering=True)
    assert abs(float(st["total_variance"]) - tv_ref) / tv_ref < 1e-5


def _geometric(n=3000, d=128, dtype=np.float32, offset=0.3, kappa=1e3):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((n, d)) * np.geomspace(1.0, 1.0 / kappa, d)
    return (x + offset).astype(dtype)


def _projection_pair(x, k=8, **kw):
    return tuple(
        _rpca(k, seed=RNG_SEED, range_finder="gram", gram_projection=p,
              **kw).fit(x)
        for p in ("data", "gram")
    )


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gram_projection_matches_data_path(dtype):
    a, b = _projection_pair(_geometric(dtype=dtype))
    sa, sb = _np(a.singular_values_), _np(b.singular_values_)
    assert np.max(np.abs(sa - sb) / sa) < (5e-5 if dtype == np.float32
                                           else 1e-11)
    vtol = 1e-3 if dtype == np.float32 else 1e-8
    assert np.max(np.abs(_np(a.components_) - _np(b.components_))) < vtol


def test_gram_projection_f64_sigma_and_fit_transform():
    x = _geometric(dtype=np.float64)
    a, b = _projection_pair(x)
    s_ref = _exact_sigma(x, 8)
    err_data = np.max(np.abs(_np(a.singular_values_) - s_ref) / s_ref)
    err_gram = np.max(np.abs(_np(b.singular_values_) - s_ref) / s_ref)
    assert err_gram < 1e-8 and err_gram < 3 * err_data + 1e-12
    m = _rpca(6, seed=RNG_SEED, range_finder="gram", gram_projection="gram")
    y_ft = _np(m.fit_transform(x))
    y_t = _np(m.transform(x))
    assert np.max(np.abs(y_ft - y_t)) < 1e-9 * np.max(np.abs(y_t))


def test_gram_projection_no_centering():
    a, b = _projection_pair(_geometric(), k=6, centering=False)
    sa, sb = _np(a.singular_values_), _np(b.singular_values_)
    assert np.max(np.abs(sa - sb) / sa) < 5e-5


def test_gram_projection_rank_deficient():
    """Collinear data: the σ cut-off zeroes the dead direction's U
    column, and nothing NaNs."""
    x = np.array([[0.0, 0.0], [3.0, 4.0], [6.0, 8.0]], np.float64)
    m = _rpca(2, seed=RNG_SEED, range_finder="gram", gram_projection="gram",
              n_power_iters=2)
    y = _np(m.fit_transform(x))
    s = _np(m.singular_values_)
    assert np.all(np.isfinite(y))
    assert abs(s[0] - np.sqrt(50.0)) < 1e-8 and abs(s[1]) < 1e-6
    assert np.max(np.abs(np.abs(y[:, 0]) - [5.0, 0.0, 5.0])) < 1e-8
    assert np.max(np.abs(y[:, 1])) < 1e-6


def test_gram_projection_forces_gram_finder_and_rejects_combos():
    x = _geometric(n=400, d=32)
    s = _np(_rpca(4, seed=RNG_SEED, gram_projection="gram").fit(x)
            .singular_values_)
    s_dir = _np(_rpca(4, seed=RNG_SEED).fit(x).singular_values_)
    assert np.max(np.abs(s - s_dir) / s_dir) < 5e-5
    xt = torch.from_numpy(x)
    omega = torch.zeros((32, 14), dtype=xt.dtype)
    with pytest.raises(ValueError, match="requires range_finder"):
        randomized_pca_fit(xt, omega, n_components=4, range_finder="direct",
                           gram_projection="gram")
    with pytest.raises(ValueError, match="mixed"):
        randomized_pca_fit(xt.double(), omega.double(), n_components=4,
                           range_finder="gram", finder_precision="f32",
                           gram_projection="gram")
    with pytest.raises(ValueError, match="omega must be"):
        randomized_pca_fit(xt, omega[:, :3], n_components=4)
