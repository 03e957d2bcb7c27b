"""``FastIca`` of the port against the JAX package's: the cases of
tests/test_fast_ica.py (ports of the reference's ica.rs:400-479) at the
same W₀, fit outputs at the float64 / float32 bands, fixed-iteration
runs at k = 16, the FastIca cases of the golden regression, sklearn and
observability tests, state carried across, the card's rungs forced on
the CPU and (on a CUDA card) a config-3 fit and the kernels it
launches.

W₀ cannot be drawn in torch from JAX's threefry stream, so each port fit
is handed the W₀ the JAX model draws (``_inject``).  The whitening's
eigen- and singular vectors carry signs of the factorization's own,
which differ between the two packages' solvers; a sign flip of a
whitened row is undone exactly by flipping the same column of W₀, so
each fit's W₀ is aligned with the two whitening matrices first
(``_whitening_signs``).
"""

import pathlib
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.models import fast_ica as jfi
from petal_decomposition_tpu.utils import rng as jax_rng
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch import config
from petal_decomposition_tpu_torch.models import fast_ica as pfi
from petal_decomposition_tpu_torch.ops import jacobi
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2
from petal_decomposition_tpu_torch.utils import rng as port_rng
from petal_decomposition_tpu_torch.utils.convert import fast_ica_from_numpy

SEED = 1_234_567_891_011_121_314  # ref: ica.rs:405
BAND = {np.dtype(np.float64): 1e-10, np.dtype(np.float32): 1e-5,
        np.dtype(np.complex128): 1e-10}


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    if not want.size:
        return 0.0
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


def _jax_w0(k, dtype, seed=SEED):
    """The W₀ a JAX model's first fit draws (key split, then normal)."""
    _, sub = jax.random.split(jax_rng.key_from_seed(seed))
    return np.array(jax_rng.normal(sub, (k, k), dtype))


def _inject(monkeypatch, w0):
    def fake_normal(gen, shape, dtype, device):
        assert tuple(shape) == w0.shape
        return torch.from_numpy(w0).to(device=device, dtype=dtype)

    monkeypatch.setattr(port_rng, "normal", fake_normal)


def _whitening_signs(x, k, solver):
    """D with K_port = D·K_jax, row by row, after checking that the two
    whitening matrices agree up to those signs at the dtype's band."""
    xt = np.ascontiguousarray((x - x.mean(0)).T)
    kj = np.asarray(jfi._whitening_matrix(jnp.asarray(xt), k, solver)[0])
    kp = pfi._whitening_matrix(torch.from_numpy(xt), k, solver)[0].numpy()
    d = np.sign(np.sum(kp * kj, axis=1))
    d[d == 0] = 1
    assert _rel(kp, d[:, None] * kj) < BAND[x.dtype]
    return d


def _aligned_w0(x, k, kw):
    w0 = _jax_w0(k, x.dtype)
    if not kw.get("whiten", True) or k == 0 or np.iscomplexobj(x):
        return w0
    solver = pfi.resolve_whiten_solver(
        kw.get("whiten_solver", "auto"), torch.from_numpy(x[:0]).dtype, "cpu")
    return w0 * _whitening_signs(x, k, solver)[None, :]


def _fits(monkeypatch, x, method="fit_transform", **kw):
    """The JAX model and the port's, each from ``SEED`` and fitted on
    ``x`` by ``method`` at the same W₀: ``(port, jax, out, out_jax)``."""
    x = np.asarray(x)
    if x.dtype.kind in "iub":
        x = x.astype(np.float64)
    n, d = x.shape
    if not kw.get("whiten", True):
        k = d
    else:
        k = min(n, d) if kw.get("n_components") is None else kw["n_components"]
    jm = jpd.FastIca(seed=SEED, **kw)
    out_j = getattr(jm, method)(x)
    _inject(monkeypatch, _aligned_w0(x, k, kw))
    pm = pt.FastIca(seed=SEED, device="cpu", **kw)
    out = getattr(pm, method)(x)
    return pm, jm, out, out_j


def _assert_same(pm, jm, x, band=None, n_iter=True):
    """components_, mean_, transform, inverse_transform, mixing_ and
    n_iter_ of the port against the JAX model's, within ``band``
    relative to each output's scale."""
    band = BAND[np.asarray(x).dtype] if band is None else band
    comp_j = np.asarray(jm.components_)
    assert pm.components_.shape == comp_j.shape
    assert _rel(pm.mean_.numpy(), np.asarray(jm.mean_)) < band
    if n_iter:
        assert pm.n_iter_ == jm.n_iter_
    if comp_j.size == 0:
        return
    assert _rel(pm.components_.numpy(), comp_j) < band
    y, y_j = pm.transform(x).numpy(), np.asarray(jm.transform(x))
    assert _rel(y, y_j) < band
    assert _rel(pm.inverse_transform(y).numpy(),
                np.asarray(jm.inverse_transform(y_j))) < band
    assert _rel(pm.mixing_.numpy(), np.asarray(jm.mixing_)) < band


def _two_sources(n, seed, mixing):
    rng = np.random.default_rng(seed)
    s = np.stack(
        [rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))], axis=1
    )
    return s @ np.asarray(mixing), s


def _mixture(n=4000, seed=5):
    x, s = _two_sources(n, seed, [[1.0, 0.3], [0.5, 1.0]])
    return x.astype(np.float64), s


def _sources(k, n, seed, dtype=np.float64):
    """k Laplace sources mixed by a random well-conditioned k×k A."""
    rng = np.random.default_rng(seed)
    s = rng.laplace(size=(n, k))
    a = np.linalg.qr(rng.standard_normal((k, k)))[0] * np.linspace(1, 3, k)
    return (s @ a.T).astype(dtype), s, a


def _sign_canonical(w, ref):
    """``w`` with each row's sign that of its dot with ``ref``'s row: odd
    contrasts admit −w as the same fixed point."""
    w = np.asarray(w)
    return w * np.sign(np.sum(w * np.asarray(ref), axis=1, keepdims=True))


# -- the goldens, errors and outputs of tests/test_fast_ica.py ----------


@pytest.mark.parametrize(
    "x,tol,max_iter,golden,n_want",
    [
        # ref: ica.rs:435-444 — one iteration.
        ([[-0.5, 0.5], [-0.3, 0.3]], 0.5, 1,
         [[0.51449576, -0.85749293], [-0.85749293, -0.51449576]], 1),
        # ref: ica.rs:447-456 — converges in exactly 6 iterations.
        ([[1.0, -1.0], [0.0, 0.0]], 1e-4, 200,
         [[-0.00172682, 0.99999851], [0.99999851, 0.00172682]], 6),
    ],
    ids=["single_iter", "multi_iter"],
)
def test_ica_par_golden(x, tol, max_iter, golden, n_want):
    x, w0 = np.array(x), np.array([[1.0, 2.0], [3.0, 4.0]])
    w, n = pfi.ica_par(torch.from_numpy(x), tol, max_iter,
                       torch.from_numpy(w0))
    assert n == n_want
    assert np.abs(w.numpy() - golden).max() < 1e-8
    w_j, n_j = jfi.ica_par(x, tol, max_iter, w0)
    assert n_j == n and _rel(w.numpy(), np.asarray(w_j)) < 1e-10


def test_logcosh_golden():
    """ref: ica.rs:459-468."""
    x = np.array([[1.0, 2.0], [3.0, 4.0]])
    g, gp = pfi.logcosh(torch.from_numpy(x))
    np.testing.assert_allclose(
        g.numpy(), [[0.76159416, 0.96402758], [0.99505475, 0.99932930]],
        rtol=1e-8)
    np.testing.assert_allclose(gp.numpy(), [0.24531258, 0.00560349],
                               rtol=1e-6)
    g_j, gp_j = jfi.logcosh(x)
    assert _rel(g.numpy(), np.asarray(g_j)) < 1e-15
    assert _rel(gp.numpy(), np.asarray(gp_j)) < 1e-15


def test_symmetric_decorrelation_golden():
    """ref: ica.rs:471-478."""
    x = np.array([[33.0, 24.0], [48.0, 57.0]])
    w = pfi.symmetric_decorrelation(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        w, [[0.96623494, -0.25766265], [0.25766265, 0.96623494]], rtol=1e-8)
    assert _rel(w, np.asarray(jfi.symmetric_decorrelation(x))) < 1e-10


@pytest.mark.parametrize("complex_input", [False, True])
def test_symmetric_decorrelation_orthonormal(complex_input):
    """W·Wᴴ = I, and the JAX package's result, on real 8×8 and complex
    5×5 input."""
    rng = np.random.default_rng(13 if complex_input else 0)
    if complex_input:
        w = rng.standard_normal((5, 5)) + 1j * rng.standard_normal((5, 5))
    else:
        w = rng.standard_normal((8, 8))
    d = pfi.symmetric_decorrelation(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(d @ d.conj().T, np.eye(len(w)), atol=1e-10)
    assert _rel(d, np.asarray(jfi.symmetric_decorrelation(w))) < 1e-10


def _error(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


@pytest.mark.parametrize(
    "case",
    ["transform_cols", "inverse_cols", "unfitted_transform",
     "unfitted_inverse", "n_components", "whiten_false_n_components",
     "whiten_false_empty_rows", "whiten_false_empty_cols",
     "not_a_matrix"],
)
def test_errors_match_jax(case):
    """The same error class and message as the JAX package on the same
    input (ref: ica.rs:124-128 for the column check)."""
    x = np.array([[0.0, 0.0], [1.0, 1.0], [1.0, -1.0]])

    def run(make):
        if case == "transform_cols":
            m = make()
            m.fit(x)
            return _error(lambda: m.transform(np.zeros((3, 5))))
        if case == "inverse_cols":
            m = make()
            m.fit(x)
            return _error(lambda: m.inverse_transform(np.zeros((4, 7))))
        if case == "unfitted_transform":
            return _error(lambda: make().transform(x))
        if case == "unfitted_inverse":
            return _error(lambda: make().inverse_transform(np.zeros((2, 3))))
        if case == "n_components":
            return _error(lambda: make(n_components=10).fit(x))
        if case == "whiten_false_n_components":
            return _error(lambda: make(whiten=False, n_components=2))
        if case == "not_a_matrix":
            return _error(lambda: make().fit(x[0]))
        shape = (0, 4) if case == "whiten_false_empty_rows" else (5, 0)
        return _error(lambda: make(whiten=False).fit(np.zeros(shape)))

    port = run(lambda **kw: pt.FastIca(seed=SEED, device="cpu", **kw))
    assert port == run(lambda **kw: jpd.FastIca(seed=SEED, **kw))
    assert port[0] == "InvalidInput"


def test_invalid_arguments_raise_value_error():
    for bad in ({"fun": "tanh"}, {"whiten_solver": "qr"},
                {"decorrelation": "newton"},
                {"iteration_precision": "bogus"}):
        with pytest.raises(ValueError):
            jpd.FastIca(**bad)
        with pytest.raises(ValueError):
            pt.FastIca(device="cpu", **bad)
    with pytest.raises(ValueError):
        pt.FastIcaBuilder().iteration_precision("bf16").build()


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize(
    "kw",
    [{"fun": "logcosh"}, {"fun": "exp"}, {"fun": "cube"},
     {"whiten_solver": "svd"}, {"decorrelation": "ns"},
     # The two packages' Gram eigensolvers give the whitening rows other
     # signs.  The aligned W₀ then runs the same updates, but the
     # reference's functional (rows of the new W against columns of the
     # old) reads other values in the flipped coordinates, so whether
     # and when a fit stops is the sign convention's: compare a fixed
     # count of iterations.
     {"whiten_solver": "eigh", "tol": 0.0, "max_iter": 4}],
    ids=lambda kw: "-".join(map(str, kw.values())),
)
def test_fit_outputs_match_jax(monkeypatch, dtype, kw):
    """Every output of a fit on the two-source family, for each
    contrast, whitening and decorrelation, at 1e-10 (float64) and 1e-5
    (float32) of each output's scale, with the same n_iter."""
    x, _ = _mixture(n=2000, seed=11)
    x = x.astype(dtype)
    pm, jm, y, y_j = _fits(monkeypatch, x, **kw)
    assert y.dtype == torch.from_numpy(x).dtype and y.shape == (2000, 2)
    _assert_same(pm, jm, x)
    assert _rel(y.numpy(), np.asarray(y_j)) < BAND[np.dtype(dtype)]


def test_auto_resolutions_by_device_type():
    """The autos resolve as the JAX package's do on its CPU and on an
    accelerator, keyed on the tensor's device type (``meta`` stands in
    for the card: neither the device nor the data is needed)."""
    card = torch.empty((4, 4), dtype=torch.float64, device="meta")
    for setting in ("eigh", "ns"):
        assert pfi.resolve_decorrelation(setting, "cuda") == setting
    assert pfi.resolve_decorrelation("auto", "cpu") == "eigh"
    assert pfi.resolve_decorrelation("auto", card.device.type) == "ns"
    assert pfi.resolve_decorrelation("auto", "cuda") == "ns"
    f64, f32, c128 = torch.float64, torch.float32, torch.complex128
    prec = pfi.resolve_iteration_precision
    assert prec("auto", f64, card.device.type) == "f32"
    assert prec("auto", f64, "cpu") == "full"
    assert prec("auto", f32, "cuda") == "full"
    assert prec("auto", c128, "cuda") == "full"
    assert prec("full", f64, "cuda") == "full"
    solver = pfi.resolve_whiten_solver
    assert solver("auto", f64, card.device.type) == "eigh"
    assert solver("auto", f64, "cpu") == "svd"
    assert solver("auto", f32, "cuda") == "svd"
    assert solver("svd", f64, "cuda") == "svd"
    # The JAX package here runs on the CPU: its autos are the CPU's.
    assert jfi.resolve_decorrelation("auto") == "eigh"
    assert jfi.resolve_iteration_precision("auto", jnp.float64) == "full"


def _prewhitened(n=4000, d=3, seed=0):
    rng = np.random.default_rng(seed)
    s0 = rng.laplace(size=(n, d))
    x = s0 @ rng.normal(size=(d, d)).T
    u, _, _ = np.linalg.svd(x - x.mean(0), full_matrices=False)
    return u * np.sqrt(n), s0


# -- fixed-iteration runs, oracles, state, rungs ------------------------


@pytest.mark.parametrize("precision", ["full", "f32"])
@pytest.mark.parametrize("decorrelation", ["eigh", "ns"])
def test_fixed_iterations_at_k16(monkeypatch, decorrelation, precision):
    """16 Laplace sources × 5000 samples, tol = 0 and 10 iterations (a
    k ≫ 2 fit stalls at its fixed point's O(n^-1/2) symmetry defect, so
    only a fixed count compares): rows sign-canonical within 1e-10 on
    the full-precision path and 1e-5 on the f32 path, where both
    packages run the same float32 stage and differ by its rounding.  Ten
    and not five: from this W₀ the map passes iterations 4-6 where the
    iterate is 100× more sensitive (each package's f32 path is 2e-5 off
    its float64 one at the 5th, 2e-7 at the 10th)."""
    x, _, _ = _sources(16, 5000, seed=41)
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=0.0, max_iter=10,
                         decorrelation=decorrelation,
                         iteration_precision=precision)
    assert pm.n_iter_ == jm.n_iter_ == 10
    comp_j = np.asarray(jm.components_)
    band = 1e-10 if precision == "full" else 1e-5
    assert _rel(_sign_canonical(pm.components_.numpy(), comp_j),
                comp_j) < band


# ref: tests/test_golden_regression.py (the JAX package's own pinned
# values, generated on its CPU backend at float64).
ICA_COMP = [
    [0.017895895859993023, -0.04841797410217456],
    [0.08630477727889607, -0.01628774590697353],
]


def test_golden_regression(monkeypatch):
    """The JAX package's pinned FastIca fit, at its W₀: components to
    1e-10 in exactly 2 iterations."""
    rng = np.random.default_rng(0)
    rng.standard_normal((20, 6))  # keeps the stream aligned with the pin
    s = np.stack([rng.uniform(-1, 1, 500), np.sign(rng.standard_normal(500))],
                 axis=1)
    xm = s @ np.array([[1.0, 0.4], [0.2, 1.0]])
    pm, jm, _, _ = _fits(monkeypatch, xm, method="fit")
    np.testing.assert_allclose(pm.components().numpy(), ICA_COMP, atol=1e-10)
    assert pm.n_iter_ == 2
    _assert_same(pm, jm, xm)


def test_sym_decorrelation_matches_sklearn():
    fastica = pytest.importorskip("sklearn.decomposition._fastica")
    w = np.random.default_rng(2).standard_normal((9, 9))
    ours = pfi.symmetric_decorrelation(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(ours, fastica._sym_decorrelation(w.copy()),
                               atol=1e-10)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_ica_par_matches_sklearn_fixed_iterations():
    """Same whitened data, same w_init, tol = 0: sklearn's ``_ica_par``
    and the port's ``ica_par`` run the same 5 updates."""
    fastica = pytest.importorskip("sklearn.decomposition._fastica")
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((6, 4000))
    w0 = rng.standard_normal((6, 6))
    w, n = pfi.ica_par(torch.from_numpy(x1), 0.0, 5, torch.from_numpy(w0))
    w_sk, _ = fastica._ica_par(x1, tol=0.0, g=fastica._logcosh, fun_args={},
                               max_iter=5, w_init=w0.copy())
    assert n == 5
    np.testing.assert_allclose(w.numpy(), w_sk, atol=1e-9)


def test_whiten_false_matches_sklearn_model():
    """sklearn's FastICA(whiten=False) and the port's ica_par at the same
    w_init and a fixed count run identical updates; the port's
    whiten=False model runs that count too."""
    from sklearn.decomposition import FastICA

    rng = np.random.default_rng(3)
    xw, _ = _prewhitened(n=2000, d=4, seed=3)
    w0 = rng.normal(size=(4, 4))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # sklearn's convergence warning
        sk = FastICA(whiten=False, algorithm="parallel", fun="logcosh",
                     w_init=w0, max_iter=7, tol=1e-30)
        y_sk = sk.fit_transform(xw)
    w, n_iter = pfi.ica_par(torch.from_numpy(xw.T), 0.0, 7,
                            torch.from_numpy(w0))
    assert n_iter == 7
    np.testing.assert_allclose(w.numpy(), sk.components_, atol=1e-10)
    np.testing.assert_allclose(xw @ w.numpy().T, y_sk, atol=1e-10)
    m = (pt.FastIcaBuilder().seed(1).whiten(False).max_iter(7).tol(1e-30)
         .device("cpu").build().fit(xw))
    assert m.n_iter_ == 7


def test_fit_stats_and_builder():
    """``last_fit_stats_.n_iter`` is the fit's n_iter_ (the FastIca case
    of tests/test_observability.py); the builder sets every knob."""
    x, _ = _two_sources(2000, 1, [[1.0, 0.2], [0.4, 1.0]])
    ica = pt.FastIca(seed=7, device="cpu").fit(x)
    assert ica.last_fit_stats_.n_iter == ica.n_iter_ >= 1
    assert ica.last_fit_stats_.n_samples == 2000
    b = (pt.FastIcaBuilder.new().seed(7).fun("exp").tol(1e-6).max_iter(9)
         .whiten(True).whiten_solver("eigh").n_components(2)
         .decorrelation("ns").iteration_precision("full").device("cpu")
         .build())
    assert (b._fun, b._tol, b._max_iter, b._whiten_solver, b._n_components,
            b._decorrelation, b._iteration_precision, b.device) == (
        "exp", 1e-6, 9, "eigh", 2, "ns", "full", torch.device("cpu"))
    assert pt.FastIca.with_seed(7).device == torch.device("cuda")
    assert pt.FastIca.new().n_iter_ == 0


@pytest.mark.parametrize(
    "make",
    [lambda: pt.FastIca(seed=0), lambda: pt.FastIca.with_seed(0),
     lambda: pt.FastIca.new(), lambda: pt.FastIcaBuilder().seed(0).build()],
    ids=["FastIca", "FastIca.with_seed", "FastIca.new", "FastIcaBuilder"],
)
def test_default_device_is_the_card(monkeypatch, make):
    """A model built without ``device=`` resolves to CUDA; on a machine
    with no card its fit raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = make()
    assert model.device == torch.device("cuda")
    x, _ = _two_sources(50, 3, [[1.0, 0.2], [0.4, 1.0]])
    for fit in (model.fit, model.fit_transform):
        with pytest.raises(RuntimeError, match='pass device="cpu"'):
            fit(x)
    assert pt.FastIca(seed=0, device="cpu").fit_transform(x).shape == (50, 2)


def test_unported_surfaces_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        pt.FastIcaBuilder().mesh(object()).build()
    m = pt.FastIca(seed=1, device="cpu")
    for call in (m.fit_batched, m.transform_batched):
        with pytest.raises(NotImplementedError, match="item 6"):
            call([np.zeros((4, 2))])


def test_state_from_a_fitted_jax_model():
    rng = np.random.default_rng(5)
    x = rng.laplace(size=(600, 3)) @ rng.normal(size=(3, 3)).T + 2.0
    jm = jpd.FastIca(seed=SEED).fit(x)
    state = {"components_": np.asarray(jm.components_),
             "mean_": np.asarray(jm.mean_), "n_iter_": jm.n_iter_,
             "fun": jm._fun, "whiten": jm._whiten,
             "n_components": jm._n_components}
    m = fast_ica_from_numpy(state, "cpu")
    assert isinstance(m, pt.FastIca) and m.n_iter_ == jm.n_iter_
    y = m.transform(x).numpy()
    assert _rel(y, np.asarray(jm.transform(x))) < 1e-10
    assert _rel(m.inverse_transform(y).numpy(),
                np.asarray(jm.inverse_transform(y))) < 1e-10
    assert _rel(m.mixing_.numpy(), np.asarray(jm.mixing_)) < 1e-10


def _card_rungs(monkeypatch):
    """Send CPU fits through the rungs the card takes: every float64 PSD
    eigh within K3's reach by ``linalg._eigh_psd_k3`` and every SVD by
    its CUDA rung, each kernel's wrapper running its plain version."""
    from petal_decomposition_tpu_torch.ops import linalg

    real_eigh, real_route = linalg.eigh_psd_jit_cert, jacobi._route

    def eigh(a):
        if k3.supports(a.shape[0], a.shape[0], a.dtype):
            return linalg._eigh_psd_k3(a)
        return real_eigh(a)

    monkeypatch.setattr(linalg, "eigh_psd_jit_cert", eigh)
    monkeypatch.setattr(jacobi, "_route",
                        lambda m, n, dtype, _dev: real_route(m, n, dtype,
                                                             "cuda"))
    monkeypatch.setattr(config, "linalg_backend", "jacobi")


def _counted(monkeypatch, module, name):
    """Record the shape of each panel ``module.name`` is called on."""
    calls = []
    real = getattr(module, name)

    def counted(a, *args):
        calls.append(tuple(a.shape))
        return real(a, *args)

    monkeypatch.setattr(module, name, counted)
    return calls


def test_f64_whitening_through_k3_on_the_cpu(monkeypatch):
    """The card's float64 path, forced on the CPU: the 16×16 Gram's
    whitening eigh and each decorrelation eigh through K3's block plain
    version, against the JAX model at 1e-10."""
    calls = _counted(monkeypatch, k3, "_jacobi_svd_block_plain_f64")
    x, _, _ = _sources(16, 5000, seed=41)
    _card_rungs(monkeypatch)
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=0.0, max_iter=10,
                         whiten_solver="eigh", decorrelation="eigh")
    # The whitening (two: the model's and the sign check's), W₀'s first
    # decorrelation and the ten in-loop ones.
    assert calls == [(16, 16)] * 13
    _assert_same(pm, jm, x)


def test_f32_whitening_through_qr_k2_on_the_cpu(monkeypatch):
    """The card's float32 whitening, forced on the CPU: Householder QR of
    the 5000×16 panel and K2's block plain version on the 16×16 R,
    against the JAX model (LAPACK's SVD) at 1e-5.  The two whitening
    matrices differ by float32 SVD rounding (≈1e-6 of K), which the
    first iterations amplify to 2-6e-5 of the components; 30 iterations
    bring both onto the map's fixed point (1.1e-6)."""
    calls = _counted(monkeypatch, k2, "_jacobi_svd_block_plain")
    monkeypatch.setattr(config, "linalg_backend", "jacobi")
    monkeypatch.setattr(jacobi, "_route", lambda m, n, dtype, dev: "qr_k2")
    x, _, _ = _sources(16, 5000, seed=41, dtype=np.float32)
    pm, jm, _, _ = _fits(monkeypatch, x, method="fit", tol=0.0, max_iter=30)
    assert calls == [(16, 16)] * 2  # the model's and the sign check's
    _assert_same(pm, jm, x)


# -- on the card ---------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_config3_fit_on_card_matches_cpu(cuda_device, dtype):
    """BASELINE config 3's shape (64 sources × 100k samples), 30 fixed
    iterations, against the same fit on the CPU through the card's rungs
    at the same W₀ (``chip_smoke.ica_card_and_cpu``), at the bands of
    ``chip_smoke.py``'s phase ``fast_ica_card_vs_cpu``.  float64 runs
    every step in float64 (the f32 stages would differ by cuBLAS's and
    the CPU's float32 rounding) with the eigh decorrelation, so K3 takes
    the Gram's eigh, W₀'s decorrelation and each step's; float32 whitens
    through QR + K2 on the 64×64 R.  By 30 iterations the map has
    contracted the two devices' rounding that its first steps amplify
    (``tools/ica_sensitivity.py``)."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    x, _, _ = _sources(64, 100_000, seed=45, dtype=np.float64)
    x = torch.from_numpy(x).to(device=cuda_device, dtype=dtype)
    kw = dict(tol=0.0, max_iter=30)
    if dtype == torch.float64:
        kw.update(decorrelation="eigh", iteration_precision="full")
    before2, before3 = k2.launches, k3.launches
    card, cpu, k_err, _ = chip_smoke.ica_card_and_cpu(pt, x, **kw)
    # The fit's launches and one more for the whitening's recomputation.
    if dtype == torch.float64:
        assert k3.launches - before3 == 33 and k2.launches == before2
    else:
        assert k2.launches - before2 == 2 and k3.launches == before3
    # float32: a Householder QR of 100k rows is exact to ≈ eps·√m ≈ 4e-5.
    assert k_err < (1e-10 if dtype == torch.float64 else 1e-4)
    assert card.n_iter_ == cpu.n_iter_ == kw["max_iter"]
    want = cpu.components_.double().numpy()
    got = _sign_canonical(card.components_.double().cpu().numpy(), want)
    err = _rel(got, want)
    assert err < (1e-9 if dtype == torch.float64 else 1e-4), err
