"""The plain references against ``numpy.linalg`` at tiny sizes, the TF32
rounding, and the seed contract they share with the program."""

import numpy as np
import pytest
import torch

from port_bench.reference import common, fast_ica, randomized_pca


def low_rank(n=600, d=24, seed=0):
    g = np.random.default_rng(seed)
    basis = np.linalg.qr(g.standard_normal((d, 6)))[0].T
    x = (g.standard_normal((n, 6)) * (3.0 * 0.5 ** np.arange(6))) @ basis
    return x + 0.01 * g.standard_normal((n, d)) + g.standard_normal(d)


def blocks_of(x, rows=128):
    t = torch.from_numpy(x)
    return lambda: (t[i:i + rows] for i in range(0, t.shape[0], rows))


def numpy_pca(x, k):
    xc = x - x.mean(0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    piv = u[np.argmax(np.abs(u[:, :k]), axis=0), np.arange(k)]
    sign = np.where(piv < 0, -1.0, 1.0)
    return s[:k], vt[:k] * sign[:, None], (s[:k] ** 2) / (xc ** 2).sum()


def test_moments_match_numpy():
    x = low_rank()
    m = randomized_pca.moments(blocks_of(x)(), "float64")
    xc = x - x.mean(0)
    assert np.allclose(m.mean.numpy(), x.mean(0), rtol=0, atol=1e-13)
    assert np.allclose(m.gram.numpy(), xc.T @ xc, rtol=1e-12, atol=1e-10)
    assert float(m.total_variance) == pytest.approx((xc ** 2).sum(), rel=1e-12)


@pytest.mark.parametrize("signs", ["u_pivot", "v_pivot"])
def test_randomized_pca_matches_numpy_svd(signs):
    x = low_rank()
    k = 4
    omega = {0: torch.from_numpy(np.random.default_rng(1).standard_normal((24, 8)))}
    sol = randomized_pca.solve(blocks_of(x), omega, k, 12, signs, "float64")[0]
    s, vt, evr = numpy_pca(x, k)
    if signs == "v_pivot":
        piv = vt[np.arange(k), np.argmax(np.abs(vt), axis=1)]
        vt = vt * np.where(piv < 0, -1.0, 1.0)[:, None]
    assert np.allclose(sol.sigma.numpy(), s, rtol=1e-10, atol=0)
    assert np.allclose(sol.components.numpy(), vt, rtol=0, atol=1e-9)
    assert np.allclose(sol.evr.numpy(), evr, rtol=1e-10, atol=0)
    assert (sol.pivot_gap > 0).all()


def test_u_pivots_merge_blocks_as_one_scan():
    x = low_rank(n=500)
    m = randomized_pca.moments(blocks_of(x)(), "float64")
    v = torch.from_numpy(np.linalg.qr(np.random.default_rng(2).standard_normal((24, 5)))[0])
    one, gap1 = randomized_pca.u_pivots(blocks_of(x, 500)(), m, v, "float64")
    many, gap2 = randomized_pca.u_pivots(blocks_of(x, 37)(), m, v, "float64")
    assert torch.equal(one, many) and torch.allclose(gap1, gap2)


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.randn(10000, dtype=torch.float32)
    r = common.round_tf32(x)
    rel = ((r - x).abs() / x.abs()).max()
    assert 2.0 ** -12 < rel <= 2.0 ** -11
    assert torch.equal(common.round_tf32(r), r)
    a, b = torch.randn(64, 256, dtype=torch.float64), torch.randn(256, 64, dtype=torch.float64)
    err = (common.mm(a.float(), b.float(), "tf32").double() - a @ b).abs().max()
    assert 1e-4 < err / (a @ b).abs().max() < 1e-2


def laplace_mix(n=3000, k=4, seed=3):
    g = np.random.default_rng(seed)
    s = g.laplace(size=(n, k))
    a = g.standard_normal((k, k)) + 2 * np.eye(k)
    return s @ a.T, a


def test_fast_ica_whitening_matches_numpy():
    x, _ = laplace_mix()
    wh = fast_ica.whiten(torch.from_numpy(x), 4, "float64")
    n = x.shape[0]
    x1 = wh.x1.numpy()
    assert np.allclose(x1 @ x1.T / n, np.eye(4), atol=1e-12)
    assert np.allclose((wh.k_mat @ wh.back).numpy(), np.eye(4), atol=1e-12)
    xc = x - x.mean(0)
    lam = np.linalg.eigvalsh(xc.T @ xc)
    assert np.allclose(np.sort(1 / np.linalg.svd(wh.k_mat.numpy())[1] ** 2), lam, rtol=1e-10)


def test_fast_ica_converges_to_a_fixed_point_that_unmixes():
    x, a = laplace_mix()
    w0 = torch.from_numpy(np.random.default_rng(4).standard_normal((4, 4)))
    comps, mean, it = fast_ica.fit(torch.from_numpy(x), w0, 4, 200, 1e-4, "float64")
    wh = fast_ica.whiten(torch.from_numpy(x), 4, "float64")
    assert fast_ica.fixed_point_residual(comps, wh) < 1e-12
    p = np.abs(comps.numpy() @ a)
    amari = ((p.sum(1) / p.max(1) - 1).sum() + (p.sum(0) / p.max(0) - 1).sum()) / 24
    assert amari < 0.05
    # A rotation away from it is no fixed point.
    q = np.linalg.qr(np.random.default_rng(5).standard_normal((4, 4)))[0]
    assert fast_ica.fixed_point_residual(torch.from_numpy(q) @ wh.k_mat, wh) > 1e-2


def test_fit_draws_follow_the_programs_seed_contract():
    from petal_decomposition_tpu_torch.utils import rng

    seed = 2 ** 31 + 99
    gen = rng.generator_from_seed(seed)
    want = [rng.normal(rng.split(gen), (7, 3), torch.float32, "cpu")
            for _ in range(4)]
    got = common.fit_draws(seed, [1, 3], (7, 3), torch.float32)
    assert torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])


@pytest.mark.parametrize("precision,tol", [("float64", 1e-12), ("tf32", 1e-2)])
def test_pseudo_inverse_matches_numpy(precision, tol):
    c = np.random.default_rng(3).standard_normal((6, 9))
    t = torch.from_numpy(c if precision == "float64" else c.astype(np.float32))
    got = fast_ica.pseudo_inverse(t, precision).double().numpy()
    want = np.linalg.pinv(c)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    if precision == "tf32":
        assert np.abs(got - want).max() > 1e-5 * np.abs(want).max()


def test_eigen_residual_reads_zero_on_the_svd_and_large_off_it():
    x = low_rank()
    m = randomized_pca.moments(blocks_of(x)(), "float64")
    s, vt, _ = numpy_pca(x, 4)
    sig, v = torch.from_numpy(s), torch.from_numpy(vt)
    scale = float(sig[0]) ** 2
    ok = randomized_pca.eigen_residual(v, sig, m.gram, scale)
    assert float(ok.max()) < 1e-12
    swapped = randomized_pca.eigen_residual(v[[1, 0, 2, 3]], sig, m.gram, scale)
    assert float(swapped[:2].min()) > 1e-2
    longer = randomized_pca.eigen_residual(2 * v, sig, m.gram, scale)
    assert float(longer.min()) >= 1.0 - 1e-12
