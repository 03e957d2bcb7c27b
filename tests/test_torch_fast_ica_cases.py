"""The behavioural cases of tests/test_fast_ica.py (ports of the
reference's ica.rs:400-479) on the port's ``FastIca``, each against the
JAX package's model on the same input at the same W₀ where the two are
defined to agree (see ``test_torch_fast_ica.py`` for the W₀ injection
and the whitening's row signs)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.models import fast_ica as jfi
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models import fast_ica as pfi
from test_torch_fast_ica import (
    SEED,
    _assert_same,
    _fits,
    _inject,
    _jax_w0,
    _mixture,
    _prewhitened,
    _rel,
    _sign_canonical,
    _two_sources,
)


def test_fit_transform_consistency(monkeypatch):
    """ref: ica.rs:407-420 — fit-then-transform equals fit_transform."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, -1.0]])
    pm, jm, y, y_j = _fits(monkeypatch, x)
    _assert_same(pm, jm, x)
    assert _rel(y.numpy(), np.asarray(y_j)) < 1e-10
    fitted = pt.FastIca(seed=SEED, device="cpu").fit(x)
    assert fitted.n_iter_ == pm.n_iter_
    np.testing.assert_allclose(fitted.transform(x).numpy(), y.numpy(),
                               atol=1e-12)


def test_recovers_sources(monkeypatch):
    """Two independent non-Gaussian sources from a linear mixture: each
    recovered component correlates ~1 with one source."""
    rng = np.random.default_rng(7)
    n = 5000
    s = np.stack([np.sign(rng.standard_normal(n)) * rng.standard_normal(n)
                  ** 2, rng.uniform(-1, 1, n)], axis=1)
    x = s @ np.array([[1.0, 0.5], [0.4, 1.2]]).T
    pm, jm, y, y_j = _fits(monkeypatch, x)
    _assert_same(pm, jm, x)
    assert _rel(y.numpy(), np.asarray(y_j)) < 1e-10
    corr = np.abs(np.corrcoef(y.numpy().T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)


@pytest.mark.parametrize("kw", [{"whiten_solver": "eigh"},
                                {"decorrelation": "ns"}],
                         ids=["whiten_eigh", "decorrelation_ns"])
def test_recovers_sources_at_each_knob(kw):
    """The Gram/eigh whitening and the Newton–Schulz decorrelation each
    unmix two sources (corr > 0.95), as in the JAX package's tests."""
    x, s = _two_sources(3000, 13, [[1.0, 0.1], [0.6, 0.9]])
    y = pt.FastIca(seed=SEED, device="cpu", **kw).fit_transform(x).numpy()
    corr = np.abs(np.corrcoef(y.T, s.T)[:2, 2:])
    assert np.all(corr.max(axis=1) > 0.95)


def test_more_features_than_samples(monkeypatch):
    """n_features > n_samples: K fills every column and the fit is
    finite (the reference reads uninitialised memory here)."""
    x = np.random.default_rng(17).standard_normal((5, 12))
    pm, jm, y, y_j = _fits(monkeypatch, x)
    assert y.shape == (5, 5)  # k = min(n, d)
    assert np.all(np.isfinite(y.numpy()))
    _assert_same(pm, jm, x)


def test_n_components(monkeypatch):
    """An explicit n_components keeps the top-k whitened directions."""
    rng = np.random.default_rng(23)
    n = 2000
    s = np.stack([rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n)),
                  rng.standard_normal(n) ** 3], axis=1)
    x = s @ rng.standard_normal((3, 6))
    pm, jm, y, _ = _fits(monkeypatch, x, n_components=3)
    assert y.shape == (n, 3) and pm.components().shape == (3, 6)
    _assert_same(pm, jm, x)


def test_ns_decorrelation_matches_eigh():
    w = np.random.default_rng(31).standard_normal((12, 12))
    a = pfi.symmetric_decorrelation(torch.from_numpy(w)).numpy()
    b = pfi.symmetric_decorrelation_ns(torch.from_numpy(w)).numpy()
    assert np.abs(a - b).max() < 1e-9
    assert np.abs(b @ b.T - np.eye(12)).max() < 1e-9
    assert _rel(b, np.asarray(jfi.symmetric_decorrelation_ns(w))) < 1e-10


@pytest.mark.parametrize(
    "dtype,decorrelation",
    [(np.float64, "eigh"), (np.float64, "ns"), (np.float32, "ns")],
)
def test_k_exceeds_data_rank(monkeypatch, dtype, decorrelation):
    """k > rank(X): dead whitened channels are zeroed by the rank cutoff
    and W·Wᴴ is a projector, not I.  The fit succeeds with finite
    output (Newton–Schulz amplifies the null directions' rounding where
    eigh gives clean zeros) and gives the JAX model's outputs."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2000, 2)) @ rng.standard_normal((2, 32)))
    x = x.astype(dtype)
    pm, jm, y, _ = _fits(monkeypatch, x, n_components=4,
                         decorrelation=decorrelation)
    assert y.shape == (2000, 4)
    assert bool(torch.isfinite(y).all())
    assert bool(torch.isfinite(pm.components_).all())
    _assert_same(pm, jm, x)


def _complex_data(rank, n=400):
    """Cubed complex Gaussian sources of ``rank`` mixed into 3 columns."""
    rng = np.random.default_rng(11)
    s = rng.standard_normal((n, rank)) + 1j * rng.standard_normal((n, rank))
    mix = rng.standard_normal((rank, 3)) + 1j * rng.standard_normal((rank, 3))
    return (s ** 3) @ mix


@pytest.mark.parametrize("rank", [3, 2], ids=["full_rank", "rank_2_of_3"])
def test_complex(monkeypatch, rank):
    """Complex input fits on the model's device (the reference is
    generic over c32/c64, lapack.rs:207-210) and behaves consistently;
    rank-deficient it stays finite (the reference NaNs: unguarded 1/σ
    and 1/√λ, ica.rs:198-200,371-374).  The whitening is the JAX
    package's up to a phase a row: each LAPACK picks its singular
    vectors' phases, and the iteration, with the reference's plain
    transposes, is not phase-equivariant, so a fit is held against the
    JAX package's at the JAX whitening
    (:func:`test_complex_fit_matches_jax_at_its_whitening`)."""
    x = _complex_data(rank)
    n = len(x)
    kw = {} if rank == 3 else {"max_iter": 30}
    m = pt.FastIca(seed=SEED, device="cpu", **kw)
    y = m.fit_transform(x).numpy()
    assert y.shape == (n, 3) and np.iscomplexobj(y)
    assert np.all(np.isfinite(y.real)) and np.all(np.isfinite(y.imag))
    m2 = pt.FastIca(seed=SEED, device="cpu", **kw).fit(x)
    np.testing.assert_allclose(m2.transform(x).numpy(), y, atol=1e-10)
    assert m2.n_iter_ == m.n_iter_
    if rank == 3:
        xt = np.ascontiguousarray((x - x.mean(0)).T)
        kj = np.asarray(jfi._whitening_matrix(jnp.asarray(xt), 3, "svd")[0])
        kp = pfi._whitening_matrix(torch.from_numpy(xt), 3, "svd")[0].numpy()
        phase = np.sum(kp * kj.conj(), axis=1)
        phase /= np.abs(phase)
        assert _rel(kp, phase[:, None] * kj) < 1e-10


@pytest.mark.parametrize("rank", [3, 2], ids=["full_rank", "rank_2_of_3"])
def test_complex_steps_match_jax(rank):
    """Each step of the complex iteration against the JAX package's from
    the same W, along the JAX trajectory from the JAX model's complex W₀
    (a real Gaussian, widened) on the JAX package's whitened panel
    K·X_cᵀ·√n: the port's next W and its stop measure lim — the contrast
    on complex wx, the update, the stop measure's plain transpose and
    the W·Wᴴ decorrelation — at 1e-12.  Whole runs part: complex FastICA
    does not settle on this data, and the map amplifies each step's
    rounding until two runs from one W₀ are O(1) apart within 30 steps,
    so a whole fit compares over two steps
    (:func:`test_complex_fit_matches_jax_at_its_whitening`)."""
    x = _complex_data(rank)
    xt = np.ascontiguousarray((x - x.mean(0)).T)
    kj = np.asarray(jfi._whitening_matrix(jnp.asarray(xt), 3, "svd")[0])
    x1 = kj @ xt * np.sqrt(len(x))
    w = _jax_w0(3, np.complex128)
    assert np.iscomplexobj(w) and not np.any(w.imag)
    for _ in range(10):
        w_j, lim_j, n_j = jfi._ica_par_core(x1, 0.0, 1, w, "logcosh")
        w_p, lim_p, n_p = pfi._ica_par_core(torch.from_numpy(x1), 0.0, 1,
                                            torch.from_numpy(w), "logcosh")
        assert int(n_j) == n_p == 1 and w_p.dtype == torch.complex128
        assert _rel(w_p.numpy(), np.asarray(w_j)) < 1e-12
        assert abs(float(lim_p) - float(lim_j)) < 1e-12
        w = np.array(w_j)


@pytest.mark.parametrize("rank", [3, 2], ids=["full_rank", "rank_2_of_3"])
def test_complex_fit_matches_jax_at_its_whitening(monkeypatch, rank):
    """A whole complex fit of two steps against the JAX model's, with
    the port's whitening matrix replaced by the JAX package's (the two
    LAPACKs pick each singular vector's phase apart) and the JAX model's
    W₀ injected: components_, mean_, transform, inverse_transform,
    mixing_ and n_iter_ at 1e-10."""
    x = _complex_data(rank)
    kw = {"tol": 0.0, "max_iter": 2}
    jm = jpd.FastIca(seed=SEED, **kw).fit(x)
    real_whitening = pfi._whitening_matrix

    def jax_whitening(xt, k, solver):
        kmat, sigma, off = real_whitening(xt, k, solver)
        kj = jfi._whitening_matrix(jnp.asarray(xt.numpy()), k, solver)[0]
        return torch.from_numpy(np.array(kj)), sigma, off

    monkeypatch.setattr(pfi, "_whitening_matrix", jax_whitening)
    _inject(monkeypatch, _jax_w0(3, np.complex128))
    pm = pt.FastIca(seed=SEED, device="cpu", **kw).fit(x)
    assert pm.components_.dtype == torch.complex128 and pm.n_iter_ == 2
    _assert_same(pm, jm, x)


def test_empty_input():
    """0-row input fits gracefully (ica.rs:174-176) and the model still
    transforms compatible input."""
    x = np.zeros((0, 4))
    for make in (lambda: pt.FastIca(seed=SEED, device="cpu"),
                 lambda: jpd.FastIca(seed=SEED)):
        m = make()
        assert tuple(m.fit_transform(x).shape) == (0, 0)
        assert tuple(m.components().shape) == (0, 4)
        assert tuple(m.mean().shape) == (4,)
        assert m.n_iter_ == 0
        assert tuple(m.transform(np.ones((3, 4))).shape) == (3, 0)


@pytest.mark.parametrize(
    "x,kw,shape",
    [
        (np.zeros((5, 0)), {}, (5, 0)),
        (np.arange(12.0).reshape(4, 3), {"n_components": 0}, (4, 0)),
        (np.array([[1.0, 2.0, 3.0]]), {}, (1, 1)),
    ],
    ids=["zero_features", "zero_components", "single_sample"],
)
def test_degenerate_fits(monkeypatch, x, kw, shape):
    pm, jm, y, y_j = _fits(monkeypatch, x, **kw)
    assert tuple(y.shape) == shape == np.asarray(y_j).shape
    assert np.all(np.isfinite(y.numpy()))
    _assert_same(pm, jm, x)
    if y.numel():
        assert _rel(y.numpy(), np.asarray(y_j)) < 1e-10
    np.testing.assert_allclose(pm.mean().numpy(), x.mean(axis=0)
                               if len(x) else np.zeros(x.shape[1]),
                               atol=1e-12)


def test_iteration_precision_mixed_matches_full(monkeypatch):
    """The f32 → ds64 → f64 stages converge to the same float64 fixed
    point as the full-precision iteration, within the JAX package's own
    band (1e-7), in both packages."""
    x, _ = _mixture()
    pm_full, jm_full, _, _ = _fits(monkeypatch, x, method="fit", tol=1e-10,
                                   iteration_precision="full")
    _assert_same(pm_full, jm_full, x)
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=1e-10,
                         iteration_precision="f32")
    assert 1 <= pm.n_iter_ <= 200
    for want in (pm_full, jm_full, jm):
        np.testing.assert_allclose(pm.components().numpy(),
                                   np.asarray(want.components()), atol=1e-7)


def test_iteration_precision_budget_cap(monkeypatch):
    """The stages share max_iter; a fit that never converges reports
    n_iter == max_iter (ica.rs:360), as the JAX package's does."""
    x = np.random.default_rng(3).standard_normal((2000, 4))
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=1e-30,
                         max_iter=7, iteration_precision="f32")
    assert pm.n_iter_ == jm.n_iter_ == 7
    xm, _ = _mixture()
    pm, jm, _, _ = _fits(monkeypatch, xm, method="fit", tol=1e-12,
                         max_iter=50, iteration_precision="f32")
    assert 1 <= pm.n_iter_ <= 50
    assert 1 <= jm.n_iter_ <= 50


def test_iteration_precision_f32_data_unaffected():
    """float32 data iterates at its own dtype whatever the setting."""
    x = _mixture()[0].astype(np.float32)
    a = pt.FastIca(seed=SEED, iteration_precision="f32",
                   device="cpu").fit_transform(x)
    b = pt.FastIca(seed=SEED, iteration_precision="full",
                   device="cpu").fit_transform(x)
    assert torch.equal(a, b)


@pytest.mark.parametrize("fun", ["exp", "cube"])
def test_iteration_precision_other_contrasts(monkeypatch, fun):
    """Every contrast's stages reach the full-precision fixed point, up
    to each row's sign."""
    x, _ = _two_sources(4000, 9, [[1.0, 0.3], [0.5, 1.0]])
    full, _, _, _ = _fits(monkeypatch, x, method="fit", tol=1e-9, fun=fun,
                          iteration_precision="full")
    mixed, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=1e-9, fun=fun,
                            iteration_precision="f32")
    full = full.components().numpy()
    for got in (mixed.components().numpy(), np.asarray(jm.components())):
        np.testing.assert_allclose(_sign_canonical(got, full), full,
                                   atol=1e-6)


def test_whitening_cutoff_f32_large_n(monkeypatch):
    """The rank cutoff grows as √n: at n = 20k in float32 a mixing whose
    weak direction is 1e-3 of the others keeps that direction's whitened
    row — its σ ratio lies above σ₀·eps·4√n and below the σ₀·eps·n a
    linear max(n, d) factor would cut — and every source is recovered.
    Against the JAX model the band is float32's 1e-5 times the mixing's
    κ, 1e3: the weak direction's whitened row is determined only to
    eps·κ by either package's SVD."""
    rng = np.random.default_rng(21)
    n = 20_000
    s = np.stack([rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n)),
                  np.sign(rng.standard_normal(n)) * rng.standard_normal(n)
                  ** 2], axis=1)
    q1 = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    q2 = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    x = (s @ (q1 @ np.diag([1.0, 1.0, 1e-3]) @ q2).T).astype(np.float32)
    sv = np.linalg.svd(x - x.mean(0, dtype=np.float64), compute_uv=False)
    eps = float(np.finfo(np.float32).eps)
    assert eps * 4 * np.sqrt(n) < sv[-1] / sv[0] < eps * n
    pm, jm, y, y_j = _fits(monkeypatch, x)
    corr = np.abs(np.corrcoef(y.numpy().T, s.T)[:3, 3:])
    assert np.all(corr.max(axis=1) > 0.9), corr.max(axis=1)
    _assert_same(pm, jm, x, band=1e-5 * 1e3)


def test_whiten_solver_auto_is_svd_on_the_cpu():
    x, _ = _mixture(seed=13)
    a = pt.FastIca(seed=SEED, whiten_solver="auto",
                   device="cpu").fit_transform(x)
    b = pt.FastIca(seed=SEED, whiten_solver="svd",
                   device="cpu").fit_transform(x)
    assert torch.equal(a, b)


def test_whiten_false(monkeypatch):
    """whiten=False (sklearn semantics): no centering, components_ IS
    the unmixing W, orthonormal on whitened input; the JAX model's
    outputs at 1e-10."""
    xw, s0 = _prewhitened()
    pm, jm, y, y_j = _fits(monkeypatch, xw, whiten=False)
    y = y.numpy()
    assert y.shape == xw.shape
    assert np.all(pm.mean_.numpy() == 0)
    w = pm.components_.numpy()
    assert np.max(np.abs(w @ w.T - np.eye(3))) < 1e-10
    np.testing.assert_allclose(pm.transform(xw).numpy(), y, atol=1e-12)
    c = np.corrcoef(y.T, s0.T)[:3, 3:]
    assert np.all(np.sort(np.abs(c), axis=1)[:, -1] > 0.95)
    _assert_same(pm, jm, xw)
    assert _rel(y, np.asarray(y_j)) < 1e-10


def test_inverse_transform_round_trip(monkeypatch):
    """inverse_transform(transform(x)) = x when k = d, and mixing_ is the
    pseudo-inverse of components_."""
    rng = np.random.default_rng(2)
    x = rng.laplace(size=(800, 3)) @ rng.normal(size=(3, 3)).T
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit")
    back = pm.inverse_transform(pm.transform(x)).numpy()
    np.testing.assert_allclose(back, x, atol=1e-8)
    np.testing.assert_allclose(pm.mixing_.numpy(),
                               np.linalg.pinv(pm.components_.numpy()),
                               atol=1e-12)
    assert pm.mixing_ is pm.mixing_  # cached for the fit
    _assert_same(pm, jm, x)
