"""The port's two-pass streamed ``FastIca.fit_batched`` and
``transform_batched`` against the JAX package's, mirroring the FastICA
cases of tests/test_streaming.py.

W₀ cannot be drawn in torch from JAX's threefry stream, so each port fit
gets the W₀ the JAX model's first fit draws, with the columns flipped
that match the rows where the two whitening matrices (each from its own
package's eigensolver of the streamed Gram) differ in sign; and the fits
run a fixed number of iterations (``tol=0``), since the reference's stop
test is not invariant to those signs (``ROADMAP.md`` §3).  Components at
1e-6 relative, the JAX streamed test's band.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.models import fast_ica as jfi
from petal_decomposition_tpu.models import streaming as jst
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.errors import InvalidInput
from petal_decomposition_tpu_torch.models import fast_ica as pfi
from petal_decomposition_tpu_torch.models import streaming as pst
from petal_decomposition_tpu_torch.utils import rng as port_rng

SEED = 1_234_567_891_011_121_314
BAND = 1e-6


def _ica_data(n=4000, k=3, seed=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 50, n)
    s = np.c_[np.sin(2 * t), np.sign(np.sin(3 * t)), rng.laplace(size=n)]
    a = rng.standard_normal((k, k)) + np.eye(k) * 2
    return (s @ a.T + 1.5).astype(dtype)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _sign_canonical(w, ref):
    w = np.asarray(w)
    return w * np.sign(np.sum(w * np.asarray(ref), axis=1, keepdims=True))


def _ica(**kw):
    return pt.FastIca(device="cpu", **kw)


def _jax_w0(k, dtype, seed=SEED):
    """The W₀ a JAX model's first fit draws (key split, then normal)."""
    _, sub = jax.random.split(jax_rng.key_from_seed(seed))
    return np.array(jax_rng.normal(sub, (k, k), dtype))


def _inject(monkeypatch, w0):
    def fake_normal(gen, shape, dtype, device):
        assert tuple(shape) == w0.shape
        return torch.from_numpy(w0).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_rng, "normal", fake_normal)


def _stream_whitening_signs(blocks, k, block_rows):
    """D with K_port = D·K_jax for the two packages' whitening matrices of
    the streamed Gram, after checking they agree up to those signs."""
    jm = jst.accumulate_moments(blocks, block_rows=block_rows)
    pm = pst.accumulate_moments(blocks, block_rows=block_rows, device="cpu")
    n, d = pm.n_samples, pm.gram.shape[0]
    kj = np.asarray(jfi.whitening_from_gram(
        jnp.asarray(np.asarray(jm.gram)), k, max(n, d))[0])
    kp = pfi.whitening_from_gram(pm.gram, k, max(n, d))[0].numpy()
    signs = np.sign(np.sum(kp * kj, axis=1))
    signs[signs == 0] = 1
    assert _rel(kp, signs[:, None] * kj) < 1e-10
    return signs


def _both_streams(monkeypatch, blocks, block_rows=1024, **kw):
    """The JAX model's streamed fit and the port's at the same W₀."""
    jm = jpd.FastIca(seed=SEED, **kw).fit_batched(blocks,
                                                  block_rows=block_rows)
    k = jm.components_.shape[0]
    w0 = _jax_w0(k, np.float64)
    if kw.get("whiten", True):
        w0 = w0 * _stream_whitening_signs(blocks, k, block_rows)[None, :]
    _inject(monkeypatch, w0)
    pm = _ica(seed=SEED, **kw).fit_batched(blocks, block_rows=block_rows)
    return pm, jm


@pytest.mark.parametrize("decorrelation", ["eigh", "ns"])
def test_stream_matches_jax_stream_at_its_w0(monkeypatch, decorrelation):
    x = _ica_data()
    blocks = [x[:1500], x[1500:3100], x[3100:]]
    pm, jm = _both_streams(monkeypatch, blocks, tol=0.0, max_iter=30,
                           decorrelation=decorrelation,
                           iteration_precision="full")
    assert pm.n_iter_ == jm.n_iter_ == 30
    assert _rel(pm.components_, jm.components_) < BAND
    assert _rel(pm.mean_, jm.mean_) < 1e-12
    y = pm.transform_batched(x, block_rows=999)
    assert _rel(y, np.asarray(jm.transform_batched(x, block_rows=999))) \
        < BAND
    st = pm.last_fit_stats_
    assert st.n_iter == 30
    assert st.extra["streamed_blocks"] == jm.last_fit_stats_.extra[
        "streamed_blocks"] == 4
    assert st.extra["whitened_buffer_cols"] == 4000


def test_stream_matches_the_in_core_eigh_fit():
    """fit_batched is the in-core ``whiten_solver="eigh"`` fit of the same
    seed: the same sub-stream for W₀, the same whitening Gram up to
    float64 accumulation roundoff, ica_par on the same X₁."""
    x = _ica_data()
    ic = _ica(seed=SEED, whiten_solver="eigh").fit(x)
    st = _ica(seed=SEED).fit_batched(
        [x[:1500], x[1500:3100], x[3100:]], block_rows=1024)
    assert st.n_iter_ == ic.n_iter_
    assert _rel(st.components_, ic.components_) < BAND
    assert _rel(st.mean_, ic.mean_) < 1e-12
    assert st.last_fit_stats_.extra["streamed_blocks"] >= 3


def test_stream_mixed_precision_matches_full():
    x = _ica_data(seed=13)
    full = _ica(seed=SEED, tol=1e-9, iteration_precision="full").fit_batched(
        x, block_rows=1024)
    mixed = _ica(seed=SEED, tol=1e-9, iteration_precision="f32").fit_batched(
        x, block_rows=1024)
    cf = full.components_.numpy()
    assert np.abs(_sign_canonical(mixed.components_, cf) - cf).max() < 1e-6


def test_stream_unmixes_from_a_memmap(tmp_path):
    x = _ica_data(seed=7)
    mm = np.memmap(tmp_path / "x.f64", dtype=np.float64, mode="w+",
                   shape=x.shape)
    mm[:] = x
    mm.flush()
    ro = np.memmap(tmp_path / "x.f64", dtype=np.float64, mode="r",
                   shape=x.shape)
    st = _ica(seed=99).fit_batched(ro, block_rows=700)
    s_st = st.transform(x).numpy()
    s_ic = _ica(seed=99, whiten_solver="eigh").fit(x).transform(x).numpy()
    c = np.corrcoef(s_st.T, s_ic.T)[:3, 3:]
    assert (np.abs(c).max(axis=1) > 0.999).all()
    tb = st.transform_batched(ro, block_rows=512)
    assert np.abs(tb.numpy() - s_st).max() < 1e-10


def test_stream_n_components_subset(monkeypatch):
    x = _ica_data(seed=11)
    pm, jm = _both_streams(monkeypatch, x, n_components=2, tol=0.0,
                           max_iter=10)
    assert tuple(pm.components_.shape) == (2, 3)
    assert _rel(pm.components_, jm.components_) < BAND
    zero = _ica(seed=3, n_components=0).fit_batched(x)
    assert tuple(zero.components_.shape) == (0, 3) and zero.n_iter_ == 0
    with pytest.raises(InvalidInput, match="at most 3"):
        _ica(seed=3, n_components=4).fit_batched(x)


def test_stream_rejects_one_shot_iterator():
    x = _ica_data()
    gen = (b for b in [x[:2000], x[2000:]])
    with pytest.raises(InvalidInput, match="one-shot"):
        _ica(seed=1).fit_batched(gen)
    with pytest.raises(InvalidInput, match="callable"):
        _ica(seed=1).fit_batched(42)
    m = _ica(seed=1).fit_batched(lambda: iter([x[:2000], x[2000:]]))
    assert tuple(m.components_.shape) == (3, 3)


def test_stream_buffer_budget(monkeypatch):
    x = _ica_data()
    monkeypatch.setenv("PETAL_STREAM_ICA_HBM_BYTES", "1024")
    with pytest.raises(InvalidInput, match="GiB"):
        _ica(seed=1).fit_batched(x)
    with pytest.raises(InvalidInput, match="GiB"):
        _ica(seed=1, whiten=False).fit_batched(x)
    monkeypatch.setenv("PETAL_STREAM_ICA_HBM_BYTES", "lots")
    with pytest.raises(InvalidInput, match="PETAL_STREAM_ICA_HBM_BYTES"):
        _ica(seed=1).fit_batched(x)
    monkeypatch.delenv("PETAL_STREAM_ICA_HBM_BYTES")
    # No limit on the CPU; the card's own memory on CUDA.
    assert pst._hbm_bytes_limit(torch.device("cpu")) is None
    monkeypatch.setenv("PETAL_STREAM_ICA_HBM_BYTES", str(64 * 2**30))
    with pytest.raises(InvalidInput, match="GiB"):
        pst._check_ica_buffer_budget(64, 100_000_000, torch.float64,
                                     torch.device("cpu"))
    pst._check_ica_buffer_budget(64, 10_000_000, torch.float64,
                                 torch.device("cpu"))


@pytest.mark.parametrize("change", ["fewer_rows", "more_rows", "width"])
def test_stream_detects_a_stream_changed_between_passes(change):
    x = _ica_data()
    calls = {"n": 0}
    second = {"fewer_rows": [x[:2000]], "more_rows": [x, x[:10]],
              "width": [x[:, :2]]}[change]

    def factory():
        calls["n"] += 1
        return iter(second if calls["n"] > 1 else [x])

    with pytest.raises(InvalidInput, match="changed between passes"):
        _ica(seed=1).fit_batched(factory, block_rows=256)
    calls["n"] = 0
    with pytest.raises(jpd.InvalidInput, match="changed between passes"):
        jpd.FastIca(seed=1).fit_batched(factory, block_rows=256)


def test_stream_whiten_false_matches_jax_and_in_core(monkeypatch):
    x = _ica_data(seed=13)
    u = np.linalg.svd(x - x.mean(0), full_matrices=False)[0]
    xw = u * np.sqrt(x.shape[0])
    blocks = [xw[:1000], xw[1000:]]
    jm = jpd.FastIca(whiten=False, seed=SEED, tol=0.0,
                     max_iter=20).fit_batched(blocks, block_rows=512)
    _inject(monkeypatch, _jax_w0(3, np.float64))
    pm = _ica(whiten=False, seed=SEED, tol=0.0, max_iter=20).fit_batched(
        blocks, block_rows=512)
    assert pm.n_iter_ == jm.n_iter_ == 20
    assert _rel(pm.components_, jm.components_) < 1e-10
    assert bool((pm.mean_ == 0).all())
    assert pm.last_fit_stats_.extra["streamed_blocks"] == jm.last_fit_stats_\
        .extra["streamed_blocks"] == 8
    monkeypatch.undo()
    ic = _ica(whiten=False, seed=21).fit(xw)
    st = _ica(whiten=False, seed=21).fit_batched(blocks, block_rows=512)
    assert st.n_iter_ == ic.n_iter_
    assert _rel(st.components_, ic.components_) < 1e-8
    with pytest.raises(InvalidInput, match="empty stream"):
        _ica(whiten=False, seed=1).fit_batched([xw[:0]])


def test_stream_rejects_pinned_svd_whitening():
    x = _ica_data()
    with pytest.raises(InvalidInput, match="whiten_solver='svd'"):
        _ica(seed=1, whiten_solver="svd").fit_batched(x)
    _ica(seed=1, whiten_solver="eigh").fit_batched(x)
    _ica(seed=1).fit_batched(x)


def test_stream_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = pt.FastIca(seed=0)
    assert model.device == torch.device("cuda")
    for kw in ({}, {"whiten": False}):
        with pytest.raises(RuntimeError, match='pass device="cpu"'):
            pt.FastIca(seed=0, **kw).fit_batched(_ica_data(n=300))


def test_stream_float32(monkeypatch):
    """A float32 stream whitens from the float64-carried Gram at float32
    and runs its iteration in float32: within the float32 band of the
    float64 stream at the same W₀."""
    x = _ica_data(seed=17)
    kw = dict(seed=SEED, tol=0.0, max_iter=30, decorrelation="eigh",
              iteration_precision="full")
    m64 = _ica(**kw).fit_batched(x, block_rows=1000)
    m32 = _ica(**kw).fit_batched(x.astype(np.float32), block_rows=1000)
    assert m32.components_.dtype == torch.float32
    want = m64.components_.numpy()
    assert _rel(_sign_canonical(m32.components_, want), want) < 1e-4
