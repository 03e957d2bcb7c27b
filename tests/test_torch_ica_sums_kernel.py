"""K6, FastICA's step sums over X₁ (``ops/kernels/ica_sums.py``): its
plain version against the host loop's sums, bit for bit; which sums the
dispatch sends to it; the wrapper's checks; fits that take the K6 route
on the CPU (through the plain version) against the eager route; and, on
a CUDA card, the kernel against a float64 reference of the same sums,
its determinism, NaN propagation and its launches in a config-3 fit."""

import pathlib
import sys

import numpy as np
import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models import fast_ica as fi
from petal_decomposition_tpu_torch.ops import splitmm
from petal_decomposition_tpu_torch.ops.kernels import ica_sums as k6
from petal_decomposition_tpu_torch.ops.linalg import mdot
from petal_decomposition_tpu_torch.parallel.mesh import make_mesh
from petal_decomposition_tpu_torch.utils import profiling


def _whitened(k, n, seed, pad=0, dtype=torch.float32, device="cpu"):
    """k rows of n whitened Laplace samples (float64 whitening), then
    ``pad`` zero columns, as a streamed or mesh buffer is padded."""
    rng = np.random.default_rng(seed)
    s = rng.laplace(size=(k, n))
    a = rng.standard_normal((k, k)) + k * np.eye(k)
    x = a @ s
    x -= x.mean(1, keepdims=True)
    lam, v = np.linalg.eigh(x @ x.T / n)
    x1 = np.concatenate([(v / np.sqrt(lam)).T @ x, np.zeros((k, pad))], 1)
    return torch.from_numpy(x1).to(device=device, dtype=dtype)


def _orthonormal(k, seed, dtype=torch.float32, device="cpu"):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((k, k)))
    return torch.from_numpy(q).to(device=device, dtype=dtype)


def _host_sums(w, x, fun):
    """``_step``'s sums as the host loop forms them without K6."""
    gwtx, gsum = fi._contrast_sums(fun, mdot(w, x))
    return mdot(gwtx, x.mT), gsum


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("fun", k6.CONTRASTS)
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("pad", [0, 37])
def test_plain_equals_the_host_sums_bitwise(fun, k, pad):
    x = _whitened(k, 3000, seed=k, pad=pad)
    w = _orthonormal(k, seed=100 + k)
    want = _host_sums(w, x, fun)
    calls, launches = k6.calls, k6.launches
    for got in (k6._ica_sums_plain(w, x, fun), k6.ica_sums(w, x, fun)):
        for g, e in zip(got, want):
            assert g.dtype == e.dtype and g.shape == e.shape
            assert torch.equal(g, e)
    assert k6.calls == calls + 1  # the wrapper's CPU path counts
    assert k6.launches == launches  # and launches nothing


def test_contrasts_are_the_models():
    assert k6.CONTRASTS == fi._CONTRASTS


def _meta(shape, dtype, place, strides=None):
    """A tensor of ``shape`` and ``dtype`` claiming the device ``place``
    without its memory: what ``supports`` reads (``is_cuda``, dtype,
    shape, strides, device)."""
    t = torch.empty(shape, dtype=dtype, device="meta")
    if strides is not None:
        t = t.as_strided(shape, strides)

    class Placed:
        is_cuda = place.startswith("cuda")
        device = torch.device(place)

        def get_device(self):
            return -1 if self.device.type == "cpu" else self.device.index

        def __getattr__(self, name):
            return getattr(t, name)

    return Placed()


@pytest.mark.parametrize("dtype,k,w_dev,x_dev,takes", [
    (torch.float32, 64, "cuda:0", "cuda:0", True),
    (torch.float32, 1, "cuda:0", "cuda:0", True),
    (torch.float32, 33, "cuda:0", "cuda:0", True),
    (torch.float32, k6.K_MAX, "cuda:0", "cuda:0", True),
    (torch.float32, k6.K_MAX + 1, "cuda:0", "cuda:0", False),
    (torch.float64, 64, "cuda:0", "cuda:0", False),
    (torch.complex64, 64, "cuda:0", "cuda:0", False),
    (torch.float32, 64, "cpu", "cpu", False),
    (torch.float32, 64, "cuda:0", "cuda:1", False),
    (torch.float32, 64, "cuda:0", "cpu", False),
])
def test_dispatch_sends_the_right_cases_to_k6(dtype, k, w_dev, x_dev, takes):
    w = _meta((k, k), dtype, w_dev)
    x = _meta((k, 1000), dtype, x_dev)
    assert k6.supports(w, x) is takes


def test_supports_needs_matching_operands():
    w = _meta((64, 64), torch.float32, "cuda:0")
    assert not k6.supports(_meta((64, 63), torch.float32, "cuda:0"),
                           _meta((64, 100), torch.float32, "cuda:0"))
    assert not k6.supports(_meta((0, 0), torch.float32, "cuda:0"),
                           _meta((0, 100), torch.float32, "cuda:0"))
    assert not k6.supports(w, _meta((63, 100), torch.float32, "cuda:0"))
    assert not k6.supports(w, _meta((64,), torch.float32, "cuda:0"))
    assert not k6.supports(w, _meta((64, 100), torch.float64, "cuda:0"))
    # Xᵀ of an n × k table, as ``whiten=False`` hands it over: not rows.
    assert not k6.supports(w, _meta((64, 100), torch.float32, "cuda:0",
                                    strides=(1, 64)))
    assert k6.supports(w, _meta((64, 100), torch.float32, "cuda:0",
                                strides=(128, 1)))


@pytest.fixture
def k6_route_on_cpu(monkeypatch):
    """Send CPU float32 sums down the K6 route (the wrapper then runs its
    plain version) and record each call's k."""
    calls = []
    real = k6.ica_sums

    def counted(w, x, fun):
        calls.append(w.shape[0])
        return real(w, x, fun)

    monkeypatch.setattr(
        k6, "supports",
        lambda w, x: w.dtype == torch.float32 and x.dtype == torch.float32)
    monkeypatch.setattr(k6, "ica_sums", counted)
    return calls


def test_the_ds64_stage_and_float64_steps_bypass_k6(k6_route_on_cpu):
    """Even where ``supports`` held for every operand, ``_step_ds`` (the
    split float32 products of the ds64 stage) and a float64 ``_step``
    keep their own arithmetic."""
    x = _whitened(5, 800, seed=4, dtype=torch.float64)
    w = _orthonormal(5, seed=4, dtype=torch.float64)
    xh, xl = splitmm.split_f64(x)
    fi._step_ds(w, xh, xl, "logcosh", fi.symmetric_decorrelation, 1 / 800)
    fi._step(w, x, "logcosh", fi.symmetric_decorrelation, 1 / 800)
    assert k6_route_on_cpu == []
    fi._step(w.float(), x.float(), "logcosh", fi.symmetric_decorrelation,
             1 / 800)
    assert k6_route_on_cpu == [5]


def test_wrapper_checks():
    w = _orthonormal(4, seed=3)
    x = _whitened(4, 500, seed=3)
    with pytest.raises(TypeError):
        k6.ica_sums(w.double(), x.double())
    with pytest.raises(TypeError):
        k6.ica_sums(w, x.double())
    with pytest.raises(ValueError):
        k6.ica_sums(w[:, :3], x)
    with pytest.raises(ValueError):
        k6.ica_sums(w, x[:3])
    with pytest.raises(ValueError):
        k6.ica_sums(w, x[0])
    with pytest.raises(ValueError):
        k6.ica_sums(w, x, "tanh")
    with pytest.raises(ValueError):
        k6.ica_sums(w, torch.empty((4, 500), device="meta"))


def _x_cols(k, n, seed):
    return _whitened(k, n, seed, dtype=torch.float64).mT.contiguous().numpy()


@pytest.mark.parametrize("fun", k6.CONTRASTS)
@pytest.mark.parametrize("entry", ["fit", "fit_batched", "mesh"])
def test_k6_route_fits_equal_the_eager_fits(k6_route_on_cpu, entry, fun):
    """A float32 fit through the K6 route (on the CPU, the plain version)
    returns the eager fit's components and n_iter bit for bit, takes the
    route once a step on each column block, and counts those calls in
    ``extra["ica_sums_kernel_calls"]``."""
    x = _x_cols(6, 4000, seed=7).astype(np.float32)
    blocks = 2 if entry == "mesh" else 1

    def fit():
        kw = dict(seed=11, device="cpu", decorrelation="ns", max_iter=25,
                  fun=fun)
        if entry == "mesh":
            kw["mesh"] = make_mesh(blocks, devices=["cpu"] * blocks)
        m = pt.FastIca(**kw)
        if entry == "fit_batched":
            return m.fit_batched([x[:1500], x[1500:]], block_rows=1500)
        return m.fit(x)

    routed = fit()
    n_routed = list(k6_route_on_cpu)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k6, "supports", lambda w, x: False)
        eager = fit()
    assert routed.n_iter_ == eager.n_iter_
    assert torch.equal(routed.components_, eager.components_)
    assert n_routed == [6] * (routed.n_iter_ * blocks)
    assert (routed.last_fit_stats_.extra["ica_sums_kernel_calls"]
            == routed.n_iter_ * blocks)
    assert eager.last_fit_stats_.extra["ica_sums_kernel_calls"] == 0


def test_k6_route_keeps_the_sums_span(k6_route_on_cpu, tmp_path):
    x1 = _whitened(5, 800, seed=5)
    w = _orthonormal(5, seed=6)
    with profiling.trace(str(tmp_path)) as prof:
        fi._step(w, x1, "logcosh", fi.symmetric_decorrelation_ns, 1 / 800)
    names = [e.name for e in prof.events()]
    assert names.count("petal.ica.sums") == 1
    assert k6_route_on_cpu == [5]


def test_other_fits_count_no_k6_sums():
    x = _x_cols(6, 2000, seed=9)
    m = pt.FastIca(seed=1, device="cpu", max_iter=5).fit(x)
    assert m.last_fit_stats_.extra["ica_sums_kernel_calls"] == 0
    r = pt.RandomizedPca(2, seed=1, device="cpu").fit(x.astype(np.float32))
    assert r.last_fit_stats_.extra["ica_sums_kernel_calls"] == 0


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reference(w, x, fun):
    """The same sums in float64 from the same float32 operands, and the
    scale a float32 evaluation errs against: each term's magnitude plus
    what W·X₁'s own rounding, ≈ |W|·|X₁| times the unit roundoff, moves
    it (through g′ for gx, g″ for gsum), summed over the columns."""
    wd, xd = w.double(), x.double()
    y = wd @ xd
    g, s = fi._contrast_sums(fun, y)
    e = torch.exp(-(y * y) / 2.0)
    gp, gpp = {"logcosh": lambda: (1.0 - g * g, -2.0 * g * (1.0 - g * g)),
               "exp": lambda: ((1.0 - y * y) * e, (y * y - 3.0) * y * e),
               "cube": lambda: (3.0 * y * y, 6.0 * y)}[fun]()
    y_abs = wd.abs() @ xd.abs()
    return (g @ xd.mT, s, (g.abs() + gp.abs() * y_abs) @ xd.abs().mT,
            (gp.abs() + gpp.abs() * y_abs).sum(1))


# K6 against the float64 sums of the same float32 operands, each entry's
# error over its scale (``_reference``).  The products are 3×TF32, summed
# eight terms at a time on the tensor cores and then in float32: a thread
# adds ≈ 200 such sums in order and the partials meet in ≈ 20 more adds,
# so an entry errs at worst ≈ 2.6e-5 of that scale (≈ 440 roundings of
# 2⁻²⁴) and at random ≈ 1e-6; tanhf's 2 ulp add a few 1e-7.
K6_BAND = 2e-5


def _check(w, x, fun):
    before = k6.launches
    gx, gsum = k6.ica_sums(w, x, fun)
    assert k6.launches == before + 1
    ref_gx, ref_gsum, scale_gx, scale_gsum = _reference(w, x, fun)
    torch.cuda.synchronize()
    k = w.shape[0]
    assert gx.shape == (k, k) and gsum.shape == (k,)
    assert gx.device == w.device and gsum.device == w.device
    err_gx = float(((gx.double() - ref_gx).abs() / scale_gx).max())
    err_gsum = float(((gsum.double() - ref_gsum).abs() / scale_gsum).max())
    assert err_gx < K6_BAND, err_gx
    assert err_gsum < K6_BAND, err_gsum


@pytest.mark.cuda
@pytest.mark.parametrize("fun", k6.CONTRASTS)
@pytest.mark.parametrize("k", [1, 5, 33, 64, k6.K_MAX])
def test_k6_matches_the_float64_sums(cuda_device, k, fun):
    """A ragged n (100,003: rows not 16-byte aligned, the last column
    block part-filled) with 37 zero columns after the data."""
    x = _whitened(k, 100_003, seed=k, pad=37, device=cuda_device)
    w = _orthonormal(k, seed=200 + k, device=cuda_device)
    _check(w, x, fun)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 63, 64, 4096, 100_000])
def test_k6_on_aligned_rows_and_short_tables(cuda_device, n):
    """16-byte rows (n a multiple of 4) take the vector copies, a view
    one column in the 4-byte ones; tables shorter than one block."""
    g = torch.Generator(device=cuda_device).manual_seed(n)
    x = torch.randn(64, n + 1, generator=g, device=cuda_device)
    w = _orthonormal(64, seed=7, device=cuda_device)
    _check(w, x[:, :n].contiguous(), "logcosh")
    _check(w, x[:, 1:], "logcosh")


@pytest.mark.cuda
def test_k6_gives_the_same_bits_twice(cuda_device):
    x = _whitened(64, 100_000, seed=1, device=cuda_device)
    w = _orthonormal(64, seed=2, device=cuda_device)
    first = [t.clone() for t in k6.ica_sums(w, x, "logcosh")]
    second = k6.ica_sums(w, x, "logcosh")
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_k6_propagates_nan(cuda_device):
    x = _whitened(8, 5000, seed=1, device=cuda_device)
    w = _orthonormal(8, seed=1, device=cuda_device)
    bad_x = x.clone()
    bad_x[3, 2000] = float("nan")
    gx, gsum = k6.ica_sums(w, bad_x, "logcosh")
    assert bool(torch.isnan(gx).all()) and bool(torch.isnan(gsum).all())
    bad_w = w.clone()
    bad_w[2, 5] = float("nan")
    gx, gsum = k6.ica_sums(bad_w, x, "logcosh")
    assert bool(torch.isnan(gx[2]).all()) and bool(torch.isnan(gsum[2]))
    assert not bool(torch.isnan(gsum[3]))


@pytest.mark.cuda
def test_config3_fit_launches_k6_once_a_step(cuda_device):
    """BASELINE config 3 in float32 at every default on the card: every
    step of the loop is one K6 launch, and the fit's stats count them."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    x = chip_smoke.ica32_data(cuda_device)
    before = k6.launches
    model = pt.FastIca(seed=3, device=cuda_device).fit(x)
    assert model.n_iter_ > 0
    assert k6.launches - before == model.n_iter_
    assert (model.last_fit_stats_.extra["ica_sums_kernel_calls"]
            == model.n_iter_)
