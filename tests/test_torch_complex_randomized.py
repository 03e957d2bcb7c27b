"""Complex ``RandomizedPca`` against the JAX package, at the Ω the JAX
key draws (a real Gaussian widened, as in the reference).

The JAX package fits complex data on the host, so its autos resolve as
on a CPU; the port keeps the data on the model's device and resolves
them the same way.  Singular vectors of complex data are unique up to a
unit phase a component, which ``svd_flip`` does not fix (it chooses a
sign); LAPACK sets that phase from the factored matrix's entries, so
rounding-level differences in B move it by ~1e4 times as much (1e-11 in
complex128, 1e-2 in complex64).  So U, the components and the transform
are held to the band after each component's phase is aligned, and in
complex128 also as they come; σ, the means, the explained variance and
the inverse transform are phase-free and held as they come."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from petal_decomposition_tpu import RandomizedPca as JaxRandomizedPca
from petal_decomposition_tpu import RandomizedPcaBuilder as JaxBuilder
from petal_decomposition_tpu.ops import linalg as jax_linalg
from petal_decomposition_tpu.parallel.distributed import (
    randomized_pca_fit as jax_fit,
)
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models.randomized_pca import RandomizedPca
from petal_decomposition_tpu_torch.ops import linalg
from petal_decomposition_tpu_torch.parallel import distributed as dist
from petal_decomposition_tpu_torch.utils import rng as port_rng

BAND = {np.complex128: 1e-10, np.complex64: 1e-5}
RNG_SEED = 1_234_567_891_011_121_314


def _data(n, d, dtype, seed=0, decay=0.75):
    """Complex decaying spectrum (σⱼ ∝ decayʲ) plus a complex mean."""
    rng = np.random.default_rng(seed)
    basis = np.linalg.qr(rng.standard_normal((d, d))
                         + 1j * rng.standard_normal((d, d)))[0]
    z = rng.standard_normal((n, d)) + 1j * rng.standard_normal((n, d))
    mu = rng.standard_normal(d) + 1j * rng.standard_normal(d)
    return (10 * (z * decay ** np.arange(d)) @ basis.conj().T
            + 0.5 * mu).astype(dtype)


def _relmax(got, want):
    got = np.asarray(got).astype(np.complex128)
    want = np.asarray(want).astype(np.complex128)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _aligned(got, want, axis):
    """``got`` with each component (a column for ``axis=0``, a row for
    ``axis=1``) turned by the unit phase that best matches ``want``."""
    got, want = np.asarray(got), np.asarray(want)
    ph = (got.conj() * want).sum(axis, keepdims=True)
    return got * (ph / np.abs(ph))


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


def _assert_same_model(pm, jm, x, y, y_j, band, raw):
    """Every output of two fitted models within ``band`` (see the module
    docstring for the phase)."""
    assert y.dtype == torch.from_numpy(x).dtype
    for got, want in ((pm.singular_values_, jm.singular_values_),
                      (pm.mean_, jm.mean_),
                      (pm.explained_variance_ratio_,
                       jm.explained_variance_ratio_),
                      (pm.explained_variance_, jm.explained_variance_)):
        assert _relmax(got, want) < band
    t, t_j = pm.transform(x).numpy(), np.asarray(jm.transform(x))
    w, w_j = pm.components_.numpy(), np.asarray(jm.components_)
    assert _relmax(_aligned(y.numpy(), y_j, 0), y_j) < band
    assert _relmax(_aligned(t, t_j, 0), t_j) < band
    assert _relmax(_aligned(w, w_j, 1), w_j) < band
    if raw:
        for got, want in ((y.numpy(), y_j), (t, t_j), (w, w_j)):
            assert _relmax(got, want) < band
    assert _relmax(pm.inverse_transform(y), jm.inverse_transform(y_j)) < band
    assert _relmax(pm.inverse_transform(t), jm.inverse_transform(t_j)) < band


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize(
    "knobs",
    [{}, {"power_iteration_normalizer": "qr", "n_power_iters": 3},
     {"centering": False}],
    ids=["defaults", "qr", "no-centering"],
)
def test_model_matches_jax_at_injected_omega(monkeypatch, dtype, knobs):
    """The model at its defaults (the JAX package's host autos: LU, the
    direct finder, explicit centering, QR) and two knob settings."""
    x = _data(300, 24, dtype)
    k, seed = 4, 2024
    jm = JaxRandomizedPca(k, seed=seed, **knobs)
    _inject(monkeypatch, _jax_model_omega(seed, x, k))
    pm = pt.RandomizedPca(k, seed=seed, device="cpu", **knobs)
    y_j = np.asarray(jm.fit_transform(x))
    y = pm.fit_transform(x)
    _assert_same_model(pm, jm, x, y, y_j, BAND[dtype],
                       raw=dtype == np.complex128)


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
@pytest.mark.parametrize(
    "kw",
    [dict(normalizer="lu", fuse_centering=False, final_orth="qr"),
     dict(normalizer="cholqr2", fuse_centering=True, final_orth="cholqr2"),
     dict(normalizer="none", fuse_centering=True, n_power_iters=0)],
    ids=["lu-explicit", "cholqr2-fused", "none-fused"],
)
def test_fit_functional_matches_jax(dtype, kw):
    """``randomized_pca_fit`` on complex data through the explicit and
    the fused centering (Xᴴ, μ̄ and |·|² in every contraction)."""
    x = _data(200, 20, dtype, seed=1)
    key = jax_rng.key_from_seed(11)
    omega = np.array(jax_rng.normal(key, (20, 15), dtype))
    st_j = jax_fit(jnp.asarray(x), key, n_components=5, **kw)
    st = dist.randomized_pca_fit(torch.from_numpy(x),
                                 torch.from_numpy(omega), n_components=5,
                                 **kw)
    band = BAND[dtype]
    s, s_j = st["sigma"].numpy()[:5], np.asarray(st_j["sigma"])[:5]
    assert _relmax(s, s_j) < band
    assert _relmax(st["means"], st_j["means"]) < band
    tv, tv_j = float(st["total_variance"]), float(st_j["total_variance"])
    assert abs(tv - tv_j) / tv_j < band
    u, u_j = st["u"].numpy()[:, :5], np.asarray(st_j["u"])[:, :5]
    assert _relmax(_aligned(u, u_j, 0), u_j) < band
    vt, vt_j = st["vt"].numpy()[:5], np.asarray(st_j["vt"])[:5]
    assert _relmax(_aligned(vt, vt_j, 1), vt_j) < band


@pytest.mark.parametrize("shape", [(40, 6), (6, 40), (9, 9)])
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_lu_pl_takes_jax_pivots(shape, dtype):
    """The complex P·L pivots by modulus, as the JAX elimination does
    (``getrf`` pivots by |Re| + |Im|)."""
    rng = np.random.default_rng(2)
    a = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(dtype)
    a[:, 0] *= 0.1
    a[1, 0], a[2, 0] = 3.0, 2.0 + 2.0j  # modulus 3 > 2.83; |Re|+|Im| 3 < 4
    got = linalg.lu_pl(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_linalg.lu_pl(a))
    assert np.abs(got - want).max() < (1e-14 if dtype == np.complex128
                                       else 1e-6)
    lu, piv, _ = torch.linalg.lu_factor_ex(torch.from_numpy(a))
    assert int(piv[0]) == 3  # getrf's own rule takes row 2 (0-based)


def test_randomized_pca_complex():
    """The JAX package's ``test_randomized_pca_complex``
    (tests/test_randomized_pca.py:152) on the port."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((60, 12)) + 1j * rng.standard_normal((60, 12))
    y = pt.RandomizedPca(3, seed=RNG_SEED, device="cpu").fit_transform(x)
    y = y.numpy()
    assert y.shape == (60, 3) and np.all(np.isfinite(y))
    pca2 = pt.RandomizedPca(3, seed=RNG_SEED, device="cpu").fit(x)
    y2 = pca2.transform(x).numpy()
    assert np.abs(y - y2).max() < 1e-8
    z = pca2.inverse_transform(y2).numpy()
    s_all = np.linalg.svd(x - x.mean(0), compute_uv=False)
    assert np.abs(z - x).max() <= s_all[3] * 2


def test_finder_precision_f32_ignored_for_complex():
    """The JAX package's test (tests/test_randomized_pca.py:303): the
    mixed float32 finder is float64-only, so ``"f32"`` on complex data
    fits exactly as ``"full"``."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((200, 10))
         + 1j * rng.standard_normal((200, 10))).astype(np.complex128)

    def fit(precision):
        return (pt.RandomizedPcaBuilder(3).seed(5).finder_precision(precision)
                .device("cpu").build().fit_transform(x).numpy())

    np.testing.assert_array_equal(fit("f32"), fit("full"))
    yj = np.asarray(JaxBuilder(3).seed(5).finder_precision("f32").build()
                    .fit_transform(x))
    assert yj.shape == fit("f32").shape


def test_complex_autos_resolve_as_the_redirected_fit(monkeypatch):
    """On a device other than the CPU (a meta tensor stands in for the
    card) a complex fit passes the JAX package's host autos to the
    pipeline, and a real one the accelerator's."""
    seen = {}

    def spy(x, omega, **kw):
        seen.update(kw)
        raise StopIteration

    monkeypatch.setattr(dist, "randomized_pca_fit", spy)
    for dtype, fast in ((torch.complex64, False), (torch.float32, True)):
        x = torch.empty((1 << 12, 1 << 10), dtype=dtype, device="meta")
        model = RandomizedPca(8, seed=1, device="cpu")
        with pytest.raises(StopIteration):
            model._inner_fit(x)
        assert seen["normalizer"] == ("cholqr2" if fast else "lu")
        assert seen["fuse_centering"] is fast
        assert seen["final_orth"] == ("cholqr2" if fast else "qr")
        assert seen["fused_sketch"] is fast
    big = (1_000_000, 1024, 42)
    assert dist._resolve_range_finder("auto", *big, "cuda",
                                      is_complex=True) == "direct"


def test_complex_errors_match_jax():
    """The Gram finder is real-only in both packages; the streams reject
    complex input."""
    x = _data(64, 8, np.complex128)
    for knobs in ({"range_finder": "gram"}, {"gram_projection": "gram"}):
        with pytest.raises(ValueError, match="real dtypes only"):
            JaxRandomizedPca(2, seed=0, **knobs).fit(x)
        with pytest.raises(ValueError, match="real dtypes only"):
            pt.RandomizedPca(2, seed=0, device="cpu", **knobs).fit(x)
    with pytest.raises(pt.InvalidInput, match="real dtypes only"):
        pt.RandomizedPca(2, seed=0, device="cpu").partial_fit(x)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.complex128, np.complex64])
def test_complex_fit_on_card_matches_cpu(cuda_device, dtype):
    """The same seed on the card and on the CPU: no kernel launches, and
    the fits agree within the band (phases aligned: cuSOLVER and LAPACK
    set them by their own conventions)."""
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel, jacobi_kernels, sketch_kernel,
    )

    x = _data(20_000, 96, dtype, seed=3)
    mods = (sketch_kernel, jacobi_kernels, jacobi_f64_kernel)
    for mod in mods:
        mod.launches = 0
    card = pt.RandomizedPca(8, seed=7, device=cuda_device)
    y = card.fit_transform(x).cpu().numpy()
    assert all(mod.launches == 0 for mod in mods)
    cpu = pt.RandomizedPca(8, seed=7, device="cpu")
    y_c = cpu.fit_transform(x).numpy()
    band = BAND[dtype]
    assert _relmax(card.singular_values_.cpu(), cpu.singular_values_) < band
    assert _relmax(_aligned(y, y_c, 0), y_c) < band
    w, w_c = card.components_.cpu().numpy(), cpu.components_.numpy()
    assert _relmax(_aligned(w, w_c, 1), w_c) < band
    assert _relmax(card.inverse_transform(card.transform(x)).cpu(),
                   cpu.inverse_transform(cpu.transform(x))) < band
