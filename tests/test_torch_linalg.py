"""The port's linalg layer against the JAX package's: svd_flip,
CholeskyQR2, P·L, QR, the plain Jacobi SVD core, the convergence
certificate, the Gram-side recovery and the fused-centering algebra."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from petal_decomposition_tpu.ops import centered as jax_centered
from petal_decomposition_tpu.ops import gram_recovery as jax_gr
from petal_decomposition_tpu.ops import linalg as jax_linalg
from petal_decomposition_tpu_torch import LinalgError, config
from petal_decomposition_tpu_torch.ops import centered, gram_recovery, linalg


def _np(t):
    return np.asarray(t)


@pytest.mark.parametrize(
    "u",
    [
        # |max| ties: the first occurrence decides (-0.5 → flip).
        [[-0.5, 0.5], [0.5, -0.5], [0.1, 0.2]],
        # a zero column: pivot +0.0 keeps the sign.
        [[0.0, 0.3], [0.0, -0.7], [0.0, 0.7]],
        [[0.2, -0.9], [-0.9, 0.2], [0.4, 0.4]],
    ],
)
def test_svd_flip_matches_jax(u):
    u = np.asarray(u)
    vt = np.arange(6.0).reshape(2, 3) - 2.5
    uj, vtj = jax_linalg.svd_flip(jnp.asarray(u), jnp.asarray(vt))
    up, vtp = linalg.svd_flip(torch.from_numpy(u), torch.from_numpy(vt))
    np.testing.assert_array_equal(up.numpy(), _np(uj))
    np.testing.assert_array_equal(vtp.numpy(), _np(vtj))


def test_cholesky_qr2_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((300, 7)) @ np.diag([1e3, 1e2, 10, 1, 1, 1, 1])
    qj = _np(jax_linalg.cholesky_qr2(jnp.asarray(a)))
    q = linalg.cholesky_qr2(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(q, qj, atol=1e-10)
    assert np.abs(q.T @ q - np.eye(7)).max() < 1e-12


def test_cholesky_qr2_rank_deficient_panel():
    """The shifted retry keeps a rank-deficient panel finite and its
    resolvable directions orthonormal."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((200, 2)) @ rng.standard_normal((2, 5))
    q = linalg.cholesky_qr2(torch.from_numpy(a)).numpy()
    assert np.isfinite(q).all()
    qj = _np(jax_linalg.cholesky_qr2(jnp.asarray(a)))
    # Both span range(a) in their two live directions.
    for qq in (q, qj):
        proj = qq @ np.linalg.pinv(qq)
        assert np.abs(proj @ a - a).max() < 1e-6 * np.abs(a).max()


@pytest.mark.parametrize("shape", [(50, 6), (6, 6), (4, 9), "rank1"])
def test_lu_pl_matches_jax(shape):
    if shape == "rank1":  # zero pivots: must not raise
        a = np.outer(np.arange(1.0, 9.0), [1.0, -2.0, 0.5])
    else:
        a = np.random.default_rng(3).standard_normal(shape)
    plj = _np(jax_linalg.lu_pl(jnp.asarray(a)))
    pl = linalg.lu_pl(torch.from_numpy(a)).numpy()
    assert pl.shape == plj.shape
    np.testing.assert_allclose(pl, plj, atol=1e-12)


def test_qr_matches_jax():
    a = np.random.default_rng(4).standard_normal((40, 5))
    qj = _np(jax_linalg.qr(jnp.asarray(a)))
    q = linalg.qr(torch.from_numpy(a)).numpy()
    np.testing.assert_allclose(q @ q.T, qj @ qj.T, atol=1e-12)
    np.testing.assert_allclose(np.abs(q), np.abs(qj), atol=1e-12)


@pytest.mark.parametrize("shape", [(30, 6), (7, 12), (20, 9)])
def test_jacobi_svd_f64_matches_jax(shape):
    """The plain core — the float64 route on every device — agrees with
    the JAX package's Jacobi SVD at the 1e-10 parity band."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(shape) @ np.diag(np.linspace(1, 5, shape[1]))
    uj, sj, vtj = jax_linalg.svd(jnp.asarray(a))
    u, s, vt = linalg.svd(torch.from_numpy(a))
    np.testing.assert_allclose(s.numpy(), _np(sj), rtol=1e-10)
    uf, vtf = linalg.svd_flip(u, vt)
    ujf, vtjf = jax_linalg.svd_flip(uj, vtj)
    np.testing.assert_allclose(uf.numpy(), _np(ujf), atol=1e-10)
    np.testing.assert_allclose(vtf.numpy(), _np(vtjf), atol=1e-10)
    assert np.abs((u.numpy() * s.numpy()) @ vt.numpy() - a).max() < 1e-12


def test_certificate_tolerance_and_error(monkeypatch):
    for dtype, jdt in ((torch.float32, np.float32),
                       (torch.float64, np.float64)):
        assert linalg.convergence_tol(dtype, 42) == pytest.approx(
            jax_linalg.convergence_tol(jdt, 42)
        )
    monkeypatch.setattr(config, "jacobi_max_sweeps", 1)
    a = torch.from_numpy(np.random.default_rng(6).standard_normal((30, 8)))
    with pytest.raises(LinalgError) as err:
        linalg.svd(a)
    assert str(err.value) == (
        "linear algebra operation failed: "
        "singular value decomposition did not converge"
    )
    with pytest.raises(LinalgError):  # a NaN certificate fails too
        linalg.check_certificate(torch.tensor(float("nan")), torch.float64,
                                 8, "x")


def test_mdot_runs_ieee_float32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with linalg.ieee_f32():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"  # restored
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_gram_recovery_matches_jax(dtype):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((400, 24)) @ np.diag(0.8 ** np.arange(24))
    g = (x.T @ x).astype(dtype)
    omega = rng.standard_normal((24, 8)).astype(dtype)
    sj, vtj, _ = jax_gr.randomized_gram_recovery(
        jnp.asarray(g), jnp.asarray(omega), n_power_iters=3
    )
    s, vt, off = gram_recovery.randomized_gram_recovery(
        torch.from_numpy(g), torch.from_numpy(omega), n_power_iters=3
    )
    rtol = 1e-10 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(s.numpy(), _np(sj), rtol=rtol)
    np.testing.assert_allclose(vt.numpy()[:5], _np(vtj)[:5],
                               atol=100 * rtol)
    assert float(off) == 0.0
    vtp = rng.standard_normal((3, 6))
    np.testing.assert_array_equal(
        gram_recovery.flip_components(torch.from_numpy(vtp)).numpy(),
        _np(jax_gr.flip_components(jnp.asarray(vtp))),
    )


def test_centered_algebra_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((50, 6)) + 3.0
    m = rng.standard_normal((6, 4))
    q = rng.standard_normal((50, 4))
    mu = x.mean(0)
    xt, mt, qt, mut = map(torch.from_numpy, (x, m, q, mu))
    xj, mj, qj, muj = map(jnp.asarray, (x, m, q, mu))
    pairs = [
        (centered.centered_matmul(xt, mt, mut),
         jax_centered.centered_matmul(xj, mj, muj)),
        (centered.centered_rmatmul(xt, qt, mut),
         jax_centered.centered_rmatmul(xj, qj, muj)),
        (centered.centered_sqnorm_guarded(xt, mut, 50),
         jax_centered.centered_sqnorm_guarded(xj, muj, 50)),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-12,
                                   atol=1e-12)


def test_sqnorm_guard_engages_on_mean_dominated_data():
    """Past the float32 ratio the total variance is recomputed from the
    explicitly centered data, keeping the 1e-5 band."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2000, 8)) + 300.0).astype(np.float32)
    xt = torch.from_numpy(x)
    mu = xt.sum(0) / 2000
    tv = float(centered.centered_sqnorm_guarded(xt, mu, 2000))
    tv_ref = ((x.astype(np.float64) - x.astype(np.float64).mean(0)) ** 2).sum()
    assert abs(tv - tv_ref) / tv_ref < 1e-5
