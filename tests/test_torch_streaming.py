"""The port's streamed PCA fits (``models/streaming.py``) against the JAX
package's: ``Pca`` and ``RandomizedPca`` ``fit_batched``,
``partial_fit`` and ``transform_batched``, the accumulator, the grade
rules, the error contract and the host→device pipeline.  The cases
mirror tests/test_streaming.py; both packages get the same blocks, made
with numpy from a seed.

Bands: σ, means, total variance and explained-variance ratio at 1e-10
(float64), components at 1e-8 after sign alignment, the float32 grade at
1e-4 against a float64 SVD.  The randomized stream runs at the Ω the JAX
model's subkey draws (``_inject_omega``): JAX's threefry stream cannot be
drawn in torch.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.errors import InvalidInput as JaxInvalidInput
from petal_decomposition_tpu.errors import LinalgError as JaxLinalgError
from petal_decomposition_tpu.models import streaming as jst
from petal_decomposition_tpu.ops import linalg as jax_linalg
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.errors import InvalidInput, LinalgError
from petal_decomposition_tpu_torch.models import streaming as pst
from petal_decomposition_tpu_torch.ops import gram as pgram
from petal_decomposition_tpu_torch.utils import rng as port_rng

F64_BAND = 1e-10
COMPONENT_BAND = 1e-8


def _data(n=5000, d=64, offset=3.0, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    # A decaying spectrum so top components are well separated.
    scales = np.linspace(3.0, 1.0, d)
    return (rng.normal(size=(n, d)) * scales + offset).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _align_signs(ref, other):
    ref, other = np.asarray(ref), np.asarray(other)
    return other * np.sign(np.sum(ref * other, axis=1))[:, None]


def _pca(k, **kw):
    return pt.Pca(k, device="cpu", **kw)


def _rpca(k, **kw):
    return pt.RandomizedPca(k, device="cpu", **kw)


def _assert_same_pca(pm, jm, band=F64_BAND):
    """σ, means, total variance, EVR and components (signs aligned) of a
    port model against a JAX model."""
    assert _rel(pm.singular_values_, jm.singular_values_) < band
    assert _rel(pm.mean_, jm.mean_) < band
    tv, tv_j = float(pm._total_variance), float(jm._total_variance)
    assert abs(tv - tv_j) / tv_j < band
    assert _rel(pm.explained_variance_ratio_, jm.explained_variance_ratio_) \
        < band
    c_j = np.asarray(jm.components_)
    assert np.abs(_align_signs(c_j, pm.components_) - c_j).max() \
        < COMPONENT_BAND
    assert pm._n_samples == jm._n_samples


def _jax_omega(seed, d, l, dtype, fits=1):
    """The Ω the ``fits``-th streamed solve of ``jpd.RandomizedPca(seed=
    seed)`` draws: its key split, then normal."""
    key = jax_rng.key_from_seed(seed)
    for _ in range(fits):
        key, sub = jax.random.split(key)
    return np.array(jax_rng.normal(sub, (d, l), dtype))


def _inject_omega(monkeypatch, omegas):
    """Make the port's Ω draws return ``omegas`` in turn."""
    it = iter(omegas)

    def fake_normal(gen, shape, dtype, device):
        w = next(it)
        assert tuple(shape) == w.shape
        return torch.from_numpy(w).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_rng, "normal", fake_normal)


# -- the exact stream ----------------------------------------------------


def test_exact_stream_matches_jax_fit_batched():
    x = _data()
    blocks = [x[:1700], x[1700:4100], x[4100:]]
    jm = jpd.Pca(5).fit_batched(blocks, block_rows=1024)
    pm = _pca(5).fit_batched(blocks, block_rows=1024)
    _assert_same_pca(pm, jm)
    assert pm.singular_values_.dtype == torch.float64
    # And the port's own in-core Gram fit, as the JAX test holds its
    # stream to the in-core one.
    ic = _pca(5, solver="gram").fit(x)
    assert _rel(pm.singular_values_, ic.singular_values_) < F64_BAND


def test_accumulate_moments_matches_jax():
    x = _data(n=3000, d=24, offset=7.0)
    jm = jst.accumulate_moments([x[:1000], x[1000:]], block_rows=512)
    pm = pst.accumulate_moments([x[:1000], x[1000:]], block_rows=512,
                                device="cpu")
    assert (pm.n_samples, pm.n_blocks) == (jm.n_samples, jm.n_blocks) \
        == (3000, 6)
    assert _rel(pm.gram, jm.gram) < F64_BAND
    assert _rel(pm.means, jm.means) < F64_BAND
    assert abs(float(pm.total_variance) / float(jm.total_variance) - 1) \
        < F64_BAND


def test_stream_block_size_invariance():
    x = _data(n=3000)
    a = _pca(4).fit_batched(x, block_rows=256)
    b = _pca(4).fit_batched(
        (x[i : i + 999] for i in range(0, 3000, 999)), block_rows=1024
    )
    assert _rel(a.singular_values_, b.singular_values_) < 1e-9
    assert np.abs(a.mean_.numpy() - b.mean_.numpy()).max() < 1e-10
    assert _rel(a.singular_values_,
                jpd.Pca(4).fit_batched(x, block_rows=256).singular_values_) \
        < F64_BAND


def test_stream_survives_mean_domination():
    """At offset 1000 a naive uncentered Gram would lose ~6 digits; the
    shifted accumulation keeps σ at 1e-9 of a numpy float64 SVD."""
    x = _data(n=4000, d=32, offset=1000.0)
    m = _pca(4).fit_batched(x, block_rows=512)
    s_ref = np.linalg.svd(x - x.mean(axis=0), compute_uv=False)[:4]
    assert _rel(m.singular_values_, s_ref) < 1e-9
    assert m.last_fit_stats_.extra["mean_shift_ratio"] < 1e-2
    jm = jpd.Pca(4).fit_batched(x, block_rows=512)
    _assert_same_pca(m, jm)


def test_stream_no_centering():
    x = _data(n=2000, d=24, offset=2.0)
    jm = jpd.Pca(3, centering=False).fit_batched(x, block_rows=512)
    pm = _pca(3, centering=False).fit_batched(x, block_rows=512)
    _assert_same_pca(pm, jm)
    assert bool((pm.mean_ == 0).all())
    ic = _pca(3, centering=False, solver="gram").fit(x)
    assert _rel(pm.singular_values_, ic.singular_values_) < F64_BAND


def test_stream_f32_grade():
    x64 = _data(n=4000, d=48)
    s_ref = np.linalg.svd(x64 - x64.mean(0), compute_uv=False)[:4]
    m32 = _pca(4).fit_batched(x64.astype(np.float32), block_rows=512)
    assert m32.singular_values_.dtype == torch.float32
    assert _rel(m32.singular_values_, s_ref) < 1e-4
    j32 = jpd.Pca(4).fit_batched(x64.astype(np.float32), block_rows=512)
    assert _rel(m32.singular_values_, j32.singular_values_) < 1e-4


# -- the randomized stream -----------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_randomized_stream_matches_jax_at_its_omega(monkeypatch, dtype):
    x = _data(dtype=dtype)
    jm = jpd.RandomizedPca(5, seed=42).fit_batched(x, block_rows=1024)
    omega = _jax_omega(42, 64, 15, dtype)
    _inject_omega(monkeypatch, [omega, omega])
    pm = _rpca(5, seed=42).fit_batched(x, block_rows=1024)
    if dtype == np.float64:
        _assert_same_pca(pm, jm)
    else:
        # The float32 Gram grade: both packages' σ within 1e-4 of the
        # float64 stream at the same Ω.
        ref = _rpca(5, seed=42).fit_batched(x.astype(np.float64),
                                            block_rows=1024)
        assert _rel(pm.singular_values_, ref.singular_values_) < 1e-4
        assert _rel(jm.singular_values_, ref.singular_values_) < 1e-4


def test_randomized_stream_rebuilds_the_in_core_recovery():
    """At the same seed the stream draws the in-core fit's Ω and rebuilds
    its zero-pass recovery from the Gram, so σ agree to roundoff; and the
    randomized σ stay within 5% of the exact ones."""
    x = _data()
    ic = _rpca(5, seed=42, range_finder="gram",
               gram_projection="gram").fit(x)
    st = _rpca(5, seed=42).fit_batched(x, block_rows=1024)
    assert _rel(st.singular_values_, ic.singular_values_) < 1e-12
    c_ic = ic.components_.numpy()
    assert np.abs(_align_signs(c_ic, st.components_) - c_ic).max() < 1e-10
    s_ex = _pca(5).fit(x).singular_values_
    assert _rel(st.singular_values_, s_ex) < 0.05


def test_randomized_stream_advances_the_generator():
    x = _data(n=1000, d=16)
    m = _rpca(3, seed=7)
    s0 = m._gen.get_state().clone()
    m.fit_batched(x, block_rows=256)
    s1 = m._gen.get_state().clone()
    assert not torch.equal(s0, s1)
    m.fit_batched(x, block_rows=256)  # a refit continues the stream
    assert not torch.equal(s1, m._gen.get_state())


def test_randomized_stream_components_orthonormal_when_deficient():
    rng = np.random.default_rng(0)
    x = np.outer(rng.normal(size=400), rng.normal(size=12))
    x = x + 1e-9 * rng.normal(size=(400, 12))
    vt = _rpca(3, seed=1).fit_batched(x, block_rows=128).components_
    assert np.abs(vt.numpy() @ vt.numpy().T - np.eye(3)).max() < 1e-5


# -- transform_batched -----------------------------------------------------


def test_transform_batched_matches_transform():
    x = _data(n=3000, d=40)
    m = _pca(6).fit_batched(x, block_rows=512)
    y = m.transform_batched([x[:1234], x[1234:1234], x[1234:]],
                            block_rows=700)
    assert isinstance(y, torch.Tensor) and y.device.type == "cpu"
    assert np.abs(y.numpy() - m.transform(x).numpy()).max() < 1e-10
    jm = jpd.Pca(6).fit_batched(x, block_rows=512)
    y_j = np.asarray(jm.transform_batched(x, block_rows=700))
    assert _rel(_align_signs(y_j.T, y.numpy().T), y_j.T) < COMPONENT_BAND
    r = _rpca(6, seed=1).fit_batched(x)
    assert np.abs(r.transform_batched(x, block_rows=999).numpy()
                  - r.transform(x).numpy()).max() < 1e-10


def test_transform_batched_tail_not_padded(monkeypatch):
    """The tail chunk keeps its true size: a small input is one chunk of
    its own rows, not a padded 65536-row block."""
    x = _data(n=100, d=8)
    m = _pca(2).fit_batched(x, block_rows=64)
    shapes = []
    orig = pst._uniform_chunks

    def spy(blocks, block_rows, **kw):
        for chunk in orig(blocks, block_rows, **kw):
            shapes.append(chunk.shape)
            yield chunk

    monkeypatch.setattr(pst, "_uniform_chunks", spy)
    y = m.transform_batched(x)  # default block_rows = 65536
    assert shapes == [(100, 8)]
    assert np.abs(y.numpy() - m.transform(x).numpy()).max() < 1e-10


def test_uniform_chunks_tail_at_its_true_size():
    """Where the JAX package pads the tail chunk with zeros (one compiled
    step for the stream), the port yields it at its true size."""
    blocks = [np.ones((3, 2)), np.ones((4, 2)), np.ones((2, 2))]
    chunks = list(pst._uniform_chunks(iter(blocks), 4))
    assert [c.shape for c in chunks] == [(4, 2), (4, 2), (1, 2)]
    padded = list(jst._uniform_chunks(iter(blocks), 4))
    assert [n for _, n in padded] == [4, 4, 1]
    assert padded[-1][0].shape == (4, 2)


# -- input contract and errors ------------------------------------------


def test_stream_int_input_promotes():
    x = np.arange(600, dtype=np.int64).reshape(100, 6) % 17
    m = _pca(2).fit_batched([x[:60], x[60:]], block_rows=64)
    assert m.singular_values_.dtype == torch.float64
    jm = jpd.Pca(2).fit_batched([x[:60], x[60:]], block_rows=64)
    assert _rel(m.singular_values_, jm.singular_values_) < F64_BAND


_X8 = _data(n=100, d=8)
_ERRORS = {
    "empty_list": lambda api: api.Pca(2).fit_batched([]),
    "empty_blocks": lambda api: api.Pca(2).fit_batched([_X8[:0]]),
    "widths": lambda api: api.Pca(2).fit_batched([_X8[:10, :5],
                                                  _X8[:10, :6]]),
    "n_below_k": lambda api: api.Pca(5).fit_batched([_X8[:3]]),
    "complex": lambda api: api.Pca(2).fit_batched(
        [_X8.astype(np.complex128)]),
    "block_rows_0": lambda api: api.Pca(2).fit_batched(_X8, block_rows=0),
    "three_d": lambda api: api.Pca(2).fit_batched([_X8[None]]),
    "not_fitted": lambda api: api.Pca(2).transform_batched(_X8[:5]),
    "empty_iterator": lambda api: api.RandomizedPca(2).fit_batched(iter([])),
}


class _OnCpu:
    """The port's models on the CPU, under the JAX package's names."""

    Pca = staticmethod(_pca)
    RandomizedPca = staticmethod(_rpca)


@pytest.mark.parametrize("case", sorted(_ERRORS))
def test_stream_errors(case):
    with pytest.raises(JaxInvalidInput):
        _ERRORS[case](jpd)
    with pytest.raises(InvalidInput):
        _ERRORS[case](_OnCpu)


def test_stream_block_rows_validation_everywhere():
    x = _data(n=64, d=8)
    fitted = _pca(2).fit_batched(x, block_rows=32)
    for call in (fitted.transform_batched, _pca(2).fit_batched,
                 _pca(2).partial_fit, _rpca(2, seed=0).fit_batched,
                 _rpca(2, seed=0).partial_fit,
                 pt.FastIca(seed=0, device="cpu").fit_batched):
        for bad in (0, -3):
            with pytest.raises(InvalidInput, match="block_rows"):
                call(x, block_rows=bad)


def test_stream_mixed_dtype_contract():
    x64 = _data(n=200, d=8)
    x32 = x64.astype(np.float32)
    with pytest.raises(InvalidInput, match="safely cast"):
        _pca(2).fit_batched([x32[:100], x64[100:]], block_rows=64)
    blocks = [x64[:80], x32[80:160], (x64[160:] * 0 + 3).astype(np.int64)]
    m = _pca(2).fit_batched(blocks, block_rows=64)
    assert m.singular_values_.dtype == torch.float64
    jm = jpd.Pca(2).fit_batched(blocks, block_rows=64)
    assert _rel(m.singular_values_, jm.singular_values_) < F64_BAND


def test_stream_empty_first_block_does_not_pin_dtype():
    x64 = _data(n=200, d=8)
    m = _pca(2).fit_batched([x64[:0].astype(np.float32), x64], block_rows=64)
    assert m.singular_values_.dtype == torch.float64
    m2 = _pca(2).fit_batched(
        [x64[:0].astype(np.int64), x64.astype(np.float32)], block_rows=64)
    assert m2.singular_values_.dtype == torch.float32


def test_stream_accepts_tensors_and_rejects_solver_full():
    x = np.random.default_rng(0).standard_normal((64, 6))
    m = _pca(2, solver="full")
    with pytest.raises(InvalidInput, match="Gram-grade"):
        m.fit_batched([x])
    with pytest.raises(InvalidInput, match="Gram-grade"):
        m.partial_fit(x)
    a = _pca(2, solver="gram").fit_batched([torch.from_numpy(x)])
    b = _pca(2).fit_batched(torch.from_numpy(x), block_rows=10)
    assert _rel(a.singular_values_, b.singular_values_) < F64_BAND


def test_stream_failed_refit_preserves_state(monkeypatch):
    x = _data(n=400, d=16)
    m = _pca(3).fit_batched(x, block_rows=128)
    sig = m.singular_values_.clone()

    def boom(off, dtype, dim, what):
        raise LinalgError(f"{what} did not converge")

    monkeypatch.setattr(pst._linalg, "check_certificate", boom)
    with pytest.raises(LinalgError):
        m.fit_batched(x, block_rows=128)
    assert torch.equal(m.singular_values_, sig)


def test_stream_stats_recorded():
    x = _data(n=1000, d=16)
    m = _pca(2).fit_batched(x, block_rows=256)
    jm = jpd.Pca(2).fit_batched(x, block_rows=256)
    st, st_j = m.last_fit_stats_, jm.last_fit_stats_
    assert (st.n_samples, st.n_features) == (1000, 16)
    assert st.extra["streamed_blocks"] == st_j.extra["streamed_blocks"] == 4
    # The shift is the first chunk's mean on both sides, so the ratios
    # agree to roundoff.
    r, r_j = st.extra["mean_shift_ratio"], st_j.extra["mean_shift_ratio"]
    assert r >= 0 and abs(r - r_j) <= 1e-8 * r_j
    assert st.wall_time_s > 0


def test_stream_sign_convention_deterministic():
    x = _data(n=800, d=12)
    vt = _pca(3).fit_batched(x).components_.numpy()
    piv = vt[np.arange(3), np.argmax(np.abs(vt), axis=1)]
    assert np.all(piv > 0)
    # The JAX package's convention: the same signs, with no alignment.
    vt_j = np.asarray(jpd.Pca(3).fit_batched(x).components_)
    assert np.abs(vt - vt_j).max() < COMPONENT_BAND


def test_streamed_fits_run_on_the_card_by_default(monkeypatch):
    """A model built without ``device=`` streams on the card; with no
    card its streamed fits raise as its in-core fits do."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _data(n=100, d=8)
    for model in (pt.Pca(2), pt.RandomizedPca(2, seed=0)):
        assert model.device == torch.device("cuda")
        for call in (model.fit_batched, model.partial_fit):
            with pytest.raises(RuntimeError, match='pass device="cpu"'):
                call(x)
    with pytest.raises(RuntimeError, match='pass device="cpu"'):
        pst.accumulate_moments(x)


# -- partial_fit ---------------------------------------------------------


def test_partial_fit_matches_fit_batched_and_jax():
    x = _data(n=6000, d=32)
    m, jm = _pca(4), jpd.Pca(4)
    for i in range(0, 6000, 2000):
        m.partial_fit(x[i : i + 2000], block_rows=512)
        jm.partial_fit(x[i : i + 2000], block_rows=512)
    ref = _pca(4).fit_batched(x, block_rows=512)
    assert _rel(m.singular_values_, ref.singular_values_) < 1e-12
    assert np.abs(m.mean_.numpy() - ref.mean_.numpy()).max() < 1e-12
    _assert_same_pca(m, jm)
    assert m._n_samples == 6000
    assert m.last_fit_stats_.extra["partial_fit_calls"] == 3
    assert m.last_fit_stats_.extra["streamed_blocks"] == 12


def test_partial_fit_usable_after_every_call():
    x = _data(n=2000, d=16)
    m = _pca(3).partial_fit(x[:1000], block_rows=256)
    assert tuple(m.transform(x[:5]).shape) == (5, 3)
    m.partial_fit(x[1000:])
    assert m._n_samples == 2000
    assert tuple(m.transform(x[:5]).shape) == (5, 3)


def test_partial_fit_randomized_matches_jax_at_its_omegas(monkeypatch):
    """Each call re-solves at the next sub-stream's Ω, in the JAX
    package's order."""
    x = _data(n=2000, d=16)
    jm = jpd.RandomizedPca(3, seed=9)
    jm.partial_fit(x[:1000], block_rows=256).partial_fit(x[1000:])
    _inject_omega(monkeypatch, [_jax_omega(9, 16, 13, np.float64, fits)
                                for fits in (1, 2)])
    pm = _rpca(3, seed=9).partial_fit(x[:1000], block_rows=256)
    pm.partial_fit(x[1000:])
    _assert_same_pca(pm, jm)


def test_partial_fit_randomized_draws_substreams():
    x = _data(n=2000, d=16)
    r = _rpca(3, seed=9)
    s0 = r._gen.get_state().clone()
    r.partial_fit(x[:1000], block_rows=256)
    s1 = r._gen.get_state().clone()
    r.partial_fit(x[1000:])
    assert not torch.equal(s0, s1)
    assert not torch.equal(s1, r._gen.get_state())
    ref = _rpca(3, seed=9).fit_batched(x, block_rows=256)
    assert _rel(r.singular_values_, ref.singular_values_) < 0.05


def test_partial_fit_full_fit_restarts_stream():
    x = _data(n=1500, d=16)
    m = _pca(3).partial_fit(x[:1000], block_rows=256)
    m.fit(x[:500])
    assert m._stream is None
    m.partial_fit(x[:700], block_rows=256)
    assert m._n_samples == 700
    m.fit_batched(x, block_rows=256)
    m.partial_fit(x[:300], block_rows=256)
    assert m._n_samples == 300
    r = _rpca(3, seed=1).partial_fit(x, block_rows=256)
    r.fit(x)
    assert r._stream is None


def test_partial_fit_pins_block_rows_and_dtype():
    x = _data(n=400, d=8)
    m = _pca(2).partial_fit(x[:200], block_rows=128)
    with pytest.raises(InvalidInput, match="fixed at 128"):
        m.partial_fit(x[200:], block_rows=64)
    m.partial_fit(x[200:], block_rows=128)  # the same value passes
    m2 = _pca(2).partial_fit(x[:200].astype(np.float32))
    with pytest.raises(InvalidInput, match="safely cast"):
        m2.partial_fit(x[200:])  # float64 into a float32 stream


def test_partial_fit_dtype_upcast_matches_fit_batched_rule():
    x64 = _data(n=400, d=8)
    m = _pca(2).partial_fit(x64[:200], block_rows=128)
    m.partial_fit(x64[200:].astype(np.float32))
    assert m.singular_values_.dtype == torch.float64
    assert m._n_samples == 400


def test_partial_fit_uncentered_state_outlives_the_next_call():
    """Without centering the installed Gram-side state must be copies:
    the next call adds to the stream's carry in place."""
    x = _data(n=600, d=8)
    m = _pca(2, centering=False)
    m.partial_fit(x[:300], block_rows=128)
    tv1 = m._total_variance
    tv1_value = float(tv1)
    m.partial_fit(x[300:], block_rows=128)
    assert float(tv1) == tv1_value
    assert float(m._total_variance) > tv1_value
    jm = jpd.Pca(2, centering=False)
    jm.partial_fit(x[:300], block_rows=128).partial_fit(x[300:])
    _assert_same_pca(m, jm)


def test_partial_fit_bad_block_is_retry_safe():
    x = _data(n=800, d=8)
    m = _pca(2).partial_fit(x[:400], block_rows=128)
    with pytest.raises(InvalidInput):
        m.partial_fit([x[400:600], x[:10, :5]])  # a wrong width later
    assert m._n_samples == 400  # nothing of the failed call

    def raising():
        yield x[400:600]
        raise RuntimeError("source failed")

    with pytest.raises(RuntimeError, match="source failed"):
        m.partial_fit(raising())
    assert m._n_samples == 400
    m.partial_fit([x[400:600], x[600:]])
    assert m._n_samples == 800
    ref = _pca(2).fit_batched(x, block_rows=128)
    assert _rel(m.singular_values_, ref.singular_values_) < 1e-12


def test_partial_fit_zero_rows_is_noop():
    x = _data(n=400, d=8)
    r = _rpca(2, seed=3).partial_fit(x, block_rows=128)
    state = r._gen.get_state().clone()
    sig = r.singular_values_.clone()
    stats = r.last_fit_stats_
    r.partial_fit(np.zeros((0, 8)))
    assert torch.equal(r._gen.get_state(), state)
    assert torch.equal(r.singular_values_, sig)
    assert r.last_fit_stats_ is stats and r._n_samples == 400


def test_partial_fit_width_mismatch_across_calls():
    m = _pca(2)
    m.partial_fit(_data(300, 16, dtype=np.float32), block_rows=100)
    with pytest.raises(InvalidInput, match="inconsistent block widths"):
        m.partial_fit(_data(300, 8, dtype=np.float32))
    assert m._n_samples == 300


# -- the Gram grade --------------------------------------------------------


def test_stream_gram_precision_resolution(monkeypatch):
    """``"auto"`` resolves per dtype and device at the first chunk:
    ``"high"`` for float32 on the card, ``"highest"`` for float64 and on
    the CPU — the JAX package's rules; explicit settings pass through."""
    def res(setting, dtype, device_type):
        return pgram.resolve(setting, pst._torch_dtype(dtype), device_type,
                             stream=True)

    assert res("default", np.float32, "cuda") == "default"
    assert res("high", np.float64, "cpu") == "high"
    assert res("auto", np.float32, "cuda") == "high"
    assert res("auto", np.float64, "cuda") == "highest"
    assert res("auto", np.float32, "cpu") == "highest"
    for platform, device_type in (("tpu", "cuda"), ("cpu", "cpu")):
        monkeypatch.setattr(jax_linalg, "effective_platform",
                            lambda p=platform: p)
        for dtype in (np.float32, np.float64):
            assert res("auto", dtype, device_type) == \
                jst._resolve_stream_precision("auto", dtype)
    x = _data(n=256, d=8)
    m = _rpca(2, seed=3).partial_fit(x, block_rows=128)
    assert m._stream.precision == "highest"
    m32 = _rpca(2, seed=3, gram_precision="default").partial_fit(
        x.astype(np.float32), block_rows=128)
    # On the CPU the "default" grade keeps the float64 carry.
    assert m32._stream.precision == "default"
    assert m32._stream.carry[0].dtype == torch.float64


def test_knobless_pca_streams_at_highest_unlike_jax_partial_fit(monkeypatch):
    """Divergence from the reference (ROADMAP.md §3, "Streamed grade
    mismatch"): the JAX package's ``_stream_gram_precision`` gives a
    ``Pca`` ``"auto"``, so its ``partial_fit`` of float32 data streams at
    ``"high"`` on an accelerator, while its ``fit_batched`` and its
    docstring say ``"highest"``.  The port's ``Pca`` streams at
    ``"highest"`` in both."""
    monkeypatch.setattr(jax_linalg, "effective_platform", lambda: "tpu")
    jax_setting = jst._stream_gram_precision(jpd.Pca(2))
    assert jst._resolve_stream_precision(jax_setting, np.float32) == "high"
    setting = pst._stream_gram_precision(_pca(2))
    assert pgram.resolve(setting, torch.float32, "cuda", stream=True) \
        == "highest"
    m = _pca(2).partial_fit(_data(n=256, d=8, dtype=np.float32),
                            block_rows=128)
    assert m._stream.precision == "highest"


def test_stream_gram_precision_plumbed():
    x = _data(n=3000, d=32)
    m_hi = _rpca(4, seed=9).fit_batched(x, block_rows=1024)
    m_def = _rpca(4, seed=9, gram_precision="default")
    m_def.fit_batched(x, block_rows=1024)
    assert _rel(m_def.singular_values_, m_hi.singular_values_) < 1e-3
    m_pf = _rpca(4, seed=9, gram_precision="default")
    m_pf.partial_fit(x, block_rows=1024)
    assert m_pf._stream.precision == "default"
    assert _rel(m_pf.singular_values_, m_def.singular_values_) < 1e-12


def test_stream_mean_nonstationarity_guard(monkeypatch):
    """A stream whose mean drifts past the grade's rating fails before
    any state changes, in both packages; a higher grade takes the same
    drift and agrees with the JAX stream at its Ω."""
    rng = np.random.default_rng(0)
    d, a = 16, 40.0
    drift = [(rng.normal(size=(500, d)) + mu).astype(np.float32)
             for mu in np.linspace(a, -a, 8)]
    m = pt.RandomizedPcaBuilder(3).seed(1).gram_precision(
        "default").device("cpu").build()
    with pytest.raises(LinalgError, match="mean-nonstationary"):
        m.fit_batched(drift, block_rows=500)
    with pytest.raises(JaxLinalgError, match="mean-nonstationary"):
        jpd.RandomizedPcaBuilder(3).seed(1).gram_precision(
            "default").build().fit_batched(drift, block_rows=500)
    with pytest.raises(InvalidInput, match="not been fitted"):
        m.transform(drift[0])
    jm = jpd.RandomizedPcaBuilder(3).seed(1).gram_precision(
        "highest").build().fit_batched(drift, block_rows=500)
    _inject_omega(monkeypatch, [_jax_omega(1, d, 13, np.float32)])
    hi = pt.RandomizedPcaBuilder(3).seed(1).gram_precision(
        "highest").device("cpu").build().fit_batched(drift, block_rows=500)
    assert _rel(hi.singular_values_, jm.singular_values_) < 1e-4


# -- the host→device pipeline ---------------------------------------------


def test_prefetch_on_off_identical(monkeypatch):
    """The prefetch worker only pipelines: the fits are bitwise those of
    the synchronous copies."""
    x = _data(4000, 32, dtype=np.float32)

    def fit(depth):
        monkeypatch.setenv("PETAL_STREAM_PREFETCH", depth)
        return _rpca(4, seed=11).fit_batched(x, block_rows=700)

    m0, m3 = fit("0"), fit("3")
    assert torch.equal(m0.singular_values_, m3.singular_values_)
    assert torch.equal(m0.components_, m3.components_)
    assert torch.equal(m0.mean_, m3.mean_)


def _threads_settle(before):
    for _ in range(50):
        if threading.active_count() <= before:
            return True
        time.sleep(0.02)
    return threading.active_count() <= before


def test_prefetch_propagates_generator_error():
    """An exception in the user's generator surfaces from fit_batched,
    and the worker thread ends with the stream."""

    def bad_blocks():
        yield _data(500, 16, dtype=np.float32)
        raise RuntimeError("source failed mid-stream")

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="source failed mid-stream"):
        _pca(2).fit_batched(bad_blocks(), block_rows=200)
    assert _threads_settle(before)


def test_prefetch_stops_the_worker_when_the_consumer_fails(monkeypatch):
    """A consumer that raises mid-stream stops and drains the worker."""
    x = _data(4000, 8)
    real = pst._accum_step
    calls = []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("consumer failed")
        return real(*args, **kw)

    monkeypatch.setattr(pst, "_accum_step", failing)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="consumer failed"):
        _pca(2).fit_batched(x, block_rows=100)
    assert len(calls) == 2
    assert _threads_settle(before)


def test_prefetch_depth_malformed_raises_invalid_input(monkeypatch):
    """Divergence from the reference (ROADMAP.md §3, "Prefetch hang"):
    a malformed ``PETAL_STREAM_PREFETCH`` raises the JAX package's bare
    ``ValueError``; the port raises ``InvalidInput``."""
    x = _data(n=100, d=8)
    for bad in ("two", "-1", "1.5"):
        monkeypatch.setenv("PETAL_STREAM_PREFETCH", bad)
        with pytest.raises(InvalidInput, match="PETAL_STREAM_PREFETCH"):
            _pca(2).fit_batched(x)
    monkeypatch.setenv("PETAL_STREAM_PREFETCH", "two")
    with pytest.raises(ValueError) as info:
        jst._prefetch_depth()
    assert not isinstance(info.value, JaxInvalidInput)


def test_prefetch_dead_worker_raises_instead_of_hanging(monkeypatch):
    """Divergence from the reference (ROADMAP.md §3, "Prefetch hang"):
    the JAX consumer waits on its queue with no timeout, so a worker
    that ends without handing over a chunk or an error hangs it forever
    (``streaming.py:365``).  The port's consumer polls the worker and
    raises within a poll.  The consumer runs in a thread joined with a
    timeout, so a hang fails the test instead of stalling the run."""
    monkeypatch.setattr(pst, "_prefetch_worker",
                        lambda chunks, stage, offer: None)
    outcome = []

    def consume():
        try:
            _pca(2).fit_batched(_data(n=300, d=8), block_rows=100)
        except RuntimeError as e:
            outcome.append(e)

    t = threading.Thread(target=consume, daemon=True)
    t0 = time.perf_counter()
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive(), "the consumer hung on a dead worker"
    assert time.perf_counter() - t0 < 5.0
    assert outcome and "prefetch worker ended" in str(outcome[0])


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_pinned_copy_stream_matches_synchronous_copies(
        cuda_device, monkeypatch, dtype):
    """The pinned staging ring and the copy stream, at 20k × 256 in
    chunks of 1500 rows (more chunks than slots, a short tail): bitwise
    the fit of synchronous copies; a read-only memmap-like input goes
    through the same ring."""
    x = _data(n=20_000, d=256, dtype=dtype, seed=3)

    def fit(depth, data):
        monkeypatch.setenv("PETAL_STREAM_PREFETCH", depth)
        return pt.RandomizedPca(8, seed=5, device=cuda_device).fit_batched(
            data, block_rows=1500)

    m0, m2 = fit("0", x), fit("2", x)
    ro = x.copy()
    ro.flags.writeable = False
    m_ro = fit("1", ro)
    for m in (m2, m_ro):
        assert torch.equal(m.singular_values_, m0.singular_values_)
        assert torch.equal(m.components_, m0.components_)
        assert torch.equal(m.mean_, m0.mean_)
    assert m2.last_fit_stats_.extra["streamed_blocks"] == 14


@pytest.mark.cuda
@pytest.mark.parametrize("when", ["first_chunk", "larger_chunk"])
def test_pinned_ring_new_block_waits_for_compute_reads(cuda_device,
                                                       monkeypatch, when):
    """A slot's new device block may reuse memory the compute stream
    still reads.  At the north-star chunk shape (65536 × 4096 float32,
    1 GiB), the producer frees a chunk-size temporary while six Grams of
    it are in flight, just before it yields the first chunk (which sizes
    every slot) or a chunk larger than the first (whose slot grows).  The
    producer is fast (its pinned buffers cached, as after a first fit),
    so only the staging copy lies between the new block's allocation and
    its copy, and the block is the temporary's memory (checked).  That is
    certain by construction: the producer frees the temporary only once
    the consumer has read every earlier chunk and waits for the next, so
    no other allocation (the consumer's float64 sums take one per chunk)
    can split the freed block before the slot takes it.  The copy must
    wait for those Grams: they, and every chunk, equal the synchronous
    result bitwise."""
    import threading

    rows, d, reps = 65536, 4096, 6
    g = torch.Generator(device=cuda_device)
    g.manual_seed(7)
    big = torch.randn(rows, d, generator=g, device=cuda_device)
    sizes = [rows] * 4 if when == "first_chunk" else [1024] + [rows] * 4
    chunks = [torch.randn(r, d, generator=g, device=cuda_device)
              .cpu().numpy() for r in sizes]
    temp_ptrs = []

    def grams(x):
        t = x + 1.0  # the chunk-size temporary
        temp_ptrs.append(t.data_ptr())
        out = t.mT @ t
        for _ in range(reps - 1):
            out += t.mT @ t
        return out

    def col_sums(block):
        return block.sum(0, dtype=torch.float64)

    want_grams = grams(big).cpu()
    want_sums = [col_sums(torch.from_numpy(c).to(cuda_device)).cpu()
                 for c in chunks]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    pinned = [torch.empty((rows, d), pin_memory=True) for _ in range(3)]
    del pinned
    got_grams = []
    trigger = 0 if when == "first_chunk" else 1
    consumer_idle = threading.Event()

    def producer():
        for i, c in enumerate(chunks):
            if i == trigger:
                # The consumer has read chunks 0..i-1 and now only waits.
                assert consumer_idle.wait(timeout=120)
                got_grams.append(grams(big))
            yield c

    monkeypatch.setenv("PETAL_STREAM_PREFETCH", "2")
    sums, block_ptrs = [], []
    if trigger == 0:
        consumer_idle.set()
    for block in pst._device_prefetch(producer(), cuda_device):
        block_ptrs.append(block.data_ptr())
        sums.append(col_sums(block))
        if len(sums) == trigger:
            consumer_idle.set()
    assert temp_ptrs[-1] in block_ptrs, "the race was not set up"
    assert torch.equal(got_grams[0].cpu(), want_grams)
    assert len(sums) == len(chunks)
    for a, b in zip(sums, want_sums):
        assert torch.equal(a.cpu(), b)
