"""K4, FastICA's fused step update (``ops/kernels/ica_update.py``): its
plain version against the host loop's ``_update`` with Newton–Schulz
decorrelation, bit for bit; which updates the dispatch sends to it; the
wrapper's checks; fits that take the K4 route on the CPU (through the
plain version) against the eager route; and, on a CUDA card, the kernel
against the eager CUDA arithmetic and its launches in a config-3 fit."""

import inspect
import pathlib
import sys

import numpy as np
import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models import fast_ica as fi
from petal_decomposition_tpu_torch.ops.kernels import ica_update as k4
from petal_decomposition_tpu_torch.ops.linalg import mdot
from petal_decomposition_tpu_torch.parallel.mesh import make_mesh
from petal_decomposition_tpu_torch.utils import profiling


def _whitened(k, n, seed, dtype=torch.float32, device="cpu"):
    """k rows of n whitened Laplace samples (float64 whitening)."""
    rng = np.random.default_rng(seed)
    s = rng.laplace(size=(k, n))
    a = rng.standard_normal((k, k)) + k * np.eye(k)
    x = a @ s
    x -= x.mean(1, keepdims=True)
    lam, v = np.linalg.eigh(x @ x.T / n)
    x1 = (v / np.sqrt(lam)).T @ x
    return torch.from_numpy(x1).to(device=device, dtype=dtype)


def _orthonormal(k, seed, dtype=torch.float32, device="cpu"):
    q, _ = np.linalg.qr(np.random.default_rng(seed).standard_normal((k, k)))
    return torch.from_numpy(q).to(device=device, dtype=dtype)


def _step_inputs(w, x1):
    """``(G·Xᵀ, g′ row sums)`` of one logcosh step, as ``_step`` forms
    them."""
    gwtx, gsum = fi._contrast_sums("logcosh", mdot(w, x1))
    return mdot(gwtx, x1.mT), gsum


def _eager_ns(m):
    """``symmetric_decorrelation_ns`` under another name: ``_update``
    runs its eager arithmetic for it."""
    return fi.symmetric_decorrelation_ns(m)


def _conditioned(k, cond, seed, pad_g0=0.0, device="cpu"):
    """``(W, G·Xᵀ, g′ sums, p_inv)`` of a step whose update W_new is
    U·diag(σ)·Vᵀ, up to float32 rounding, with κ(W_new·W_newᵀ) =
    ``cond``: orthonormal W, row sums of g′ ≈ 0.6 a sample plus
    ``pad_g0``, and G·Xᵀ = (W_new + diag(g)·W)/p_inv."""
    rng = np.random.default_rng(seed)
    u, _ = np.linalg.qr(rng.standard_normal((k, k)))
    v, _ = np.linalg.qr(rng.standard_normal((k, k)))
    w, _ = np.linalg.qr(rng.standard_normal((k, k)))
    sigma = np.logspace(0.0, -0.5 * np.log10(cond), k)
    g = 0.6 + 0.05 * rng.standard_normal(k)
    p_inv = 1.0 / 4096
    f32 = dict(dtype=torch.float32, device=device)
    gx = ((u * sigma) @ v.T + g[:, None] * w) / p_inv
    return (torch.tensor(w, **f32), torch.tensor(gx, **f32),
            torch.tensor(g / p_inv + pad_g0, **f32), p_inv)


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 16])
@pytest.mark.parametrize("pad_g0", [0.0, 37.0])
def test_plain_equals_update_bitwise(k, pad_g0):
    x1 = _whitened(k, 3000, seed=k)
    w = _orthonormal(k, seed=100 + k)
    gx, gsum = _step_inputs(w, x1)
    p_inv = 1.0 / (x1.shape[1] + 37)
    want = fi._update(w, gx, gsum + pad_g0, fi.symmetric_decorrelation_ns,
                      p_inv, pad_g0)
    got = k4._ica_update_plain(w, gx, gsum + pad_g0, p_inv, pad_g0)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and g.shape == e.shape
        assert torch.equal(g, e)


def test_plain_runs_the_default_ns_iterations():
    """K4 runs ``symmetric_decorrelation_ns``'s default count, the one
    ``_update`` runs when it is handed the function itself."""
    default = inspect.signature(fi.symmetric_decorrelation_ns).parameters
    assert default["iters"].default == k4.NS_ITERS == 24


def _meta(shape, dtype, device):
    """A tensor of ``shape`` and ``dtype`` claiming ``device`` without
    its memory: what ``supports`` reads (``is_cuda``, dtype, shape)."""
    t = torch.empty(shape, dtype=dtype, device="meta")

    class Placed:
        is_cuda = device == "cuda"

        def __getattr__(self, name):
            return getattr(t, name)

    return Placed()


@pytest.mark.parametrize("dtype,k,device,decorr,takes", [
    (torch.float32, 64, "cuda", "ns", True),
    (torch.float32, 1, "cuda", "ns", True),
    (torch.float32, k4.K_MAX, "cuda", "ns", True),
    (torch.float32, k4.K_MAX + 1, "cuda", "ns", False),
    (torch.float64, 64, "cuda", "ns", False),
    (torch.complex64, 64, "cuda", "ns", False),
    (torch.float32, 64, "cuda", "eigh", False),
    (torch.float32, 64, "cuda", "ns_other", False),
    (torch.float32, 64, "cpu", "ns", False),
])
def test_dispatch_sends_the_right_cases_to_k4(dtype, k, device, decorr,
                                              takes):
    fns = {"ns": fi.symmetric_decorrelation_ns,
           "eigh": fi.symmetric_decorrelation, "ns_other": _eager_ns}
    w = _meta((k, k), dtype, device)
    assert fi._k4_takes(w, fns[decorr]) is takes
    assert k4.supports(w) is (takes or decorr != "ns")


def test_supports_needs_a_square_matrix():
    assert not k4.supports(_meta((64, 63), torch.float32, "cuda"))
    assert not k4.supports(_meta((64,), torch.float32, "cuda"))
    assert not k4.supports(_meta((0, 0), torch.float32, "cuda"))


def test_wrapper_checks_and_cpu_plain():
    w = _orthonormal(4, seed=3)
    gx, gsum = _step_inputs(w, _whitened(4, 500, seed=3))
    with pytest.raises(TypeError):
        k4.ica_update(w.double(), gx.double(), gsum.double(), 1e-3)
    with pytest.raises(ValueError):
        k4.ica_update(w, gx[:, :3], gsum, 1e-3)
    with pytest.raises(ValueError):
        k4.ica_update(w, gx, gsum[:3], 1e-3)
    with pytest.raises(TypeError):
        k4.ica_update(w, gx.double(), gsum, 1e-3)
    before = k4.launches
    got = k4.ica_update(w, gx, gsum, 1e-3, 2.0)
    want = k4._ica_update_plain(w, gx, gsum, 1e-3, 2.0)
    assert all(torch.equal(g, e) for g, e in zip(got, want))
    assert k4.launches == before  # the plain version is no launch


@pytest.fixture
def k4_route_on_cpu(monkeypatch):
    """Send CPU updates down the K4 route (the wrapper then runs its
    plain version) and count the calls."""
    calls = []
    real = k4.ica_update

    def counted(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(k4, "supports",
                        lambda w: w.dtype == torch.float32 and w.dim() == 2)
    monkeypatch.setattr(k4, "ica_update", counted)
    return calls


def _x_cols(k, n, seed):
    return _whitened(k, n, seed, dtype=torch.float64).mT.contiguous().numpy()


@pytest.mark.parametrize("entry", ["fit", "fit_batched", "mesh"])
def test_k4_route_fits_equal_the_eager_fits(k4_route_on_cpu, entry):
    """A float32 fit through the K4 route (on the CPU, the plain version)
    returns the eager fit's components and n_iter bit for bit, and
    takes the route once a step."""
    x = _x_cols(6, 4000, seed=7).astype(np.float32)

    def fit():
        kw = dict(seed=11, device="cpu", decorrelation="ns", max_iter=25)
        if entry == "mesh":
            kw["mesh"] = make_mesh(2, devices=["cpu"] * 2)
        m = pt.FastIca(**kw)
        if entry == "fit_batched":
            return m.fit_batched([x[:1500], x[1500:]])
        return m.fit(x)

    routed = fit()
    n_routed = list(k4_route_on_cpu)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(k4, "supports", lambda w: False)
        eager = fit()
    assert routed.n_iter_ == eager.n_iter_
    assert torch.equal(routed.components_, eager.components_)
    assert n_routed == [6] * routed.n_iter_


def test_k4_route_keeps_the_decorrelate_span(k4_route_on_cpu, tmp_path):
    x1 = _whitened(5, 800, seed=5)
    w = _orthonormal(5, seed=6)
    with profiling.trace(str(tmp_path)) as prof:
        fi._step(w, x1, "logcosh", fi.symmetric_decorrelation_ns, 1 / 800)
    names = [e.name for e in prof.events()]
    assert names.count("petal.ica.decorrelate") == 1
    assert k4_route_on_cpu == [5]


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(got, want) -> float:
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


def _lim_err(got, want) -> float:
    """lim is a distance from 1 (``| |row·col| − 1 |``): its error is
    relative to 1, or to lim where lim is larger."""
    return float(abs(float(got) - float(want)) / max(1.0, abs(float(want))))


def _check_against_eager(w, gx, gsum, p_inv, pad_g0, band=1e-5):
    before = k4.launches
    w1, lim = k4.ica_update(w, gx, gsum, p_inv, pad_g0)
    assert k4.launches == before + 1
    want_w1, want_lim = fi._update(w, gx, gsum, _eager_ns, p_inv, pad_g0)
    torch.cuda.synchronize()
    assert w1.shape == w.shape and w1.device == w.device and lim.dim() == 0
    assert _rel(w1, want_w1) < band, _rel(w1, want_w1)
    assert _lim_err(lim, want_lim) < band, (float(lim), float(want_lim))
    return w1, lim


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 33, 64, 100, k4.K_MAX])
@pytest.mark.parametrize("pad_g0", [0.0, 37.0])
def test_k4_matches_the_eager_update(cuda_device, k, pad_g0):
    """An update with κ(W_new·W_newᵀ) = 100, where two float32 orders of
    the sums agree to a few 1e-6 (3.5e-6 at k = 128 on the CPU); k = 100
    leaves the last CTA's rows all padding."""
    w, gx, gsum, p_inv = _conditioned(k, 100.0, seed=k, pad_g0=pad_g0,
                                      device=cuda_device)
    _check_against_eager(w, gx, gsum, p_inv, pad_g0)


@pytest.mark.cuda
def test_k4_matches_the_eager_update_on_a_config3_step(cuda_device):
    """W after three steps of BASELINE config 3's float32 fit (100k × 64
    Laplace sources, κ(A) = 4), its step's sums from the whitened table,
    and a mesh-shaped call (G·Xᵀ and the sums as views of one buffer)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    x = chip_smoke.ica32_data(cuda_device)
    xc = x - x.mean(0)
    kmat = fi._whitening_matrix(xc.mT, 64, "svd")[0]
    n = x.shape[0]
    x1 = mdot(kmat, xc.mT) * n ** 0.5
    g = torch.Generator().manual_seed(5)
    w = fi.symmetric_decorrelation(torch.randn(64, 64, generator=g).to(x1))
    for _ in range(3):
        w, _ = fi._step(w, x1, "logcosh", _eager_ns, 1.0 / n)
    gx, gsum = _step_inputs(w, x1)
    w1, _ = _check_against_eager(w, gx, gsum, 1.0 / n, 0.0)
    both = torch.cat([gx, gsum[:, None]], dim=1)
    w1_views, _ = k4.ica_update(w, both[:, :-1], both[:, -1], 1.0 / n)
    assert torch.equal(w1_views, w1)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, k4.K_MAX])
def test_k4_on_an_ill_conditioned_update(cuda_device, k):
    """κ(W_new·W_newᵀ) = 1e4.  There two float32 orders of the same sums
    differ by more than 1e-5 (the plain version against correctly
    rounded products: 5.7e-5 at k = 64, 8.1e-5 at 128, on the CPU), so
    the kernel is held to the float64 iteration of the same input, as
    close as float32 gets in its worse order with 2.5 times the room
    (the plain version: 5.8e-5 and 7.8e-5 from it), and its W1 to
    orthonormality (the plain version: 5.8e-5, 9.4e-5)."""
    pad_g0 = 3.0
    w, gx, gsum, p_inv = _conditioned(k, 1e4, seed=k, pad_g0=pad_g0,
                                      device=cuda_device)
    w1, lim = k4.ica_update(w, gx, gsum, p_inv, pad_g0)
    r_w1, r_lim = k4._ica_update_plain(w.double(), gx.double(),
                                       gsum.double(), p_inv, pad_g0)
    torch.cuda.synchronize()
    assert _rel(w1, r_w1) < 2e-4, _rel(w1, r_w1)
    assert _lim_err(lim, r_lim) < 2e-4, (float(lim), float(r_lim))
    gram = w1.double() @ w1.double().mT
    eye = torch.eye(k, device=cuda_device, dtype=torch.float64)
    assert float((gram - eye).abs().max()) < 2.5e-4


@pytest.mark.cuda
def test_k4_propagates_nan(cuda_device):
    w = _orthonormal(8, seed=1, device=cuda_device)
    gx, gsum = _step_inputs(w, _whitened(8, 1000, seed=1, device=cuda_device))
    gx[3, 2] = float("nan")
    w1, lim = k4.ica_update(w, gx, gsum, 1e-3)
    assert bool(torch.isnan(lim)) and bool(torch.isnan(w1).any())


@pytest.mark.cuda
def test_config3_fit_launches_k4_once_a_step(cuda_device):
    """BASELINE config 3 in float32 at every default on the card: every
    step of the loop is one K4 launch."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    x = chip_smoke.ica32_data(cuda_device)
    before = k4.launches
    model = pt.FastIca(seed=3, device=cuda_device).fit(x)
    assert model.n_iter_ > 0
    assert k4.launches - before == model.n_iter_
