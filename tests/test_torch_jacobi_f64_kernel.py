"""K3, the float64 one-sided Jacobi SVD kernel: its plain versions (the
TPU kernel's order and the block schedule of the Hopper kernel) against
the JAX Pallas kernel (df64) under the TPU interpreter and LAPACK, the
wrapper's block plan, reach and checks, the routes that run it, and (on
a CUDA card) the hand-written kernel against its block plain version."""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.ops import linalg as jax_linalg
from petal_decomposition_tpu.ops.pallas import jacobi_f64_kernel as jax_k3
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops import jacobi, linalg
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2

ROOT = Path(__file__).resolve().parents[1]


def _panel(kind, m, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "rankdef":
        return rng.standard_normal((m, 3)) @ rng.standard_normal((3, n))
    if kind == "nan":
        a = rng.standard_normal((m, n))
        a[m // 2, 1] = np.nan
        return a
    a = rng.standard_normal((m, n)) @ np.diag(np.linspace(1, 10, n))
    if kind == "zerocol":
        a[:, [1, n // 2]] = 0.0
    return a


def _rank(kind, n):
    return {"rankdef": 3, "zerocol": n - 2}.get(kind, n)


def _factors(a_rot, v):
    """Sorted σ, U·σ and V from a (columns uᵢσᵢ, V) pair."""
    a_rot = np.asarray(a_rot, np.float64)
    v = np.asarray(v, np.float64)
    s = np.linalg.norm(a_rot, axis=0)
    order = np.argsort(-s, kind="stable")
    return s[order], a_rot[:, order], v[:, order]


def _check_factors(a, s, us, v, s_ref):
    """The bands of the JAX package's own df64 kernel test
    (test_pallas_kernels.py:57-60): σ and reconstruction to 1e-11,
    orthogonality to 1e-12."""
    n = a.shape[1]
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-11
    assert np.abs(us @ v.T - a).max() / np.abs(a).max() < 1e-11
    assert np.abs(v.T @ v - np.eye(n)).max() < 1e-12


@functools.lru_cache(maxsize=None)
def _jax_kernel(kind, m, n):
    """The JAX df64 kernel's sorted factors under the TPU interpreter."""
    import jax.numpy as jnp

    with pltpu.force_tpu_interpret_mode():
        ar_j, v_j, off_j = jax_k3.jacobi_svd_vmem_f64(
            jnp.asarray(_panel(kind, m, n))
        )
    return (*_factors(ar_j, v_j), float(off_j))


def _check_against_jax(kind, m, n, ar, v, off):
    """σ, reconstruction and orthogonality against LAPACK; σ and the
    vectors of the resolved directions (signs aligned) against the JAX
    kernel; both converge under the kernel's own tolerance."""
    a = _panel(kind, m, n)
    assert ar.shape == (m, n) and v.shape == (n, n) and off.shape == ()
    assert ar.dtype == torch.float64
    s, us, vv = _factors(ar.numpy(), v.numpy())
    s_j, us_j, vv_j, off_j = _jax_kernel(kind, m, n)
    s_ref = np.linalg.svd(a, compute_uv=False)
    _check_factors(a, s, us, vv, s_ref)
    assert np.abs(s - s_j).max() / s_ref[0] < 1e-11
    r = _rank(kind, n)
    sign = np.sign((vv[:, :r] * vv_j[:, :r]).sum(0))
    assert np.abs(vv[:, :r] - vv_j[:, :r] * sign).max() < 1e-10
    assert np.abs(us[:, :r] - us_j[:, :r] * sign).max() / s_ref[0] < 1e-11
    tol = k3._tol(m, n)
    assert float(off) <= tol and off_j <= tol


@pytest.mark.parametrize(
    "kind,m,n",
    [
        ("full", 50, 8),      # even n
        ("full", 33, 7),      # odd n: one zero column
        ("full", 64, 64),     # square
        ("rankdef", 40, 10),  # rank 3: zero columns must skip, not NaN
    ],
)
def test_plain_matches_jax_kernel(kind, m, n):
    """The TPU kernel's order, in PyTorch, against the kernel itself."""
    a = torch.from_numpy(_panel(kind, m, n))
    _check_against_jax(kind, m, n, *k3._jacobi_svd_plain_f64(a, 30))


# (kind, m, n, w): w None is the wrapper's plan, P = 1 for these sizes.
BLOCK_CASES = [
    ("full", 50, 8, None),     # P = 1: the single-CTA case
    ("full", 50, 8, 2),        # P = 2
    ("full", 33, 7, None),     # odd n, P = 1
    ("full", 33, 7, 2),        # odd n, P = 2: one padding column
    ("full", 45, 13, 3),       # n not a multiple of 2w: 5 padding columns
    ("full", 48, 48, None),    # square, P = 1 at the widest block pair
    ("full", 64, 64, 8),       # square, P = 4
    ("full", 30, 29, 1),       # w = 1: 2P − 1 = 29 outer steps of one pair
    ("rankdef", 40, 10, None),
    ("rankdef", 40, 10, 2),
    ("zerocol", 40, 10, None),
    ("zerocol", 40, 10, 3),
]


@pytest.mark.parametrize("kind,m,n,w", BLOCK_CASES)
def test_block_plain_matches_jax_kernel(kind, m, n, w):
    a = torch.from_numpy(_panel(kind, m, n))
    if w is None:
        assert k3.plan(m, n)[1] == 1
        out = k3.jacobi_svd_vmem_f64(a)  # the wrapper's CPU route
    else:
        out = k3._jacobi_svd_block_plain_f64(a, 30, w)
    _check_against_jax(kind, m, n, *out)


def test_wrapper_runs_the_block_plain_version_on_the_cpu():
    a = torch.from_numpy(_panel("full", 40, 9))
    ar, v, off = k3.jacobi_svd_vmem_f64(a)
    ar2, v2, off2 = k3._jacobi_svd_block_plain_f64(a, 30, k3.plan(40, 9)[0])
    assert torch.equal(ar, ar2) and torch.equal(v, v2)
    assert float(off) == float(off2)


def test_constants_are_the_tpu_kernels():
    assert k3.EPS == jax_k3._EPS == 2.0 ** -48
    assert k3.TOL_EPS == jax_k3._TOL_EPS == 2.0 ** -46
    # The stop rule stays under the certificate's 2⁻⁴⁵·√dim.
    from petal_decomposition_tpu_torch.ops.linalg import convergence_tol

    assert k3._tol(1000, 64) < convergence_tol(torch.float64, 1000)


def test_plain_is_k2s_plain_at_float64():
    a = torch.from_numpy(_panel("full", 40, 9))
    ar, v, off = k3._jacobi_svd_plain_f64(a, 30)
    ar2, v2, off2 = k2._jacobi_svd_plain(a, 30, eps=k3.EPS,
                                         tol_eps=k3.TOL_EPS)
    assert torch.equal(ar, ar2) and torch.equal(v, v2)
    assert float(off) == float(off2)


def test_non_finite_panel_never_certifies():
    a = torch.from_numpy(_panel("nan", 40, 8))
    _, _, off = k3.jacobi_svd_vmem_f64(a)
    assert not float(off) <= k3._tol(40, 8)


@pytest.mark.parametrize("w", [1, 2, 3])
def test_non_finite_panel_never_certifies_across_blocks(w):
    a = torch.from_numpy(_panel("nan", 40, 8))
    _, _, off = k3._jacobi_svd_block_plain_f64(a, 30, w)
    assert not float(off) <= k3._tol(40, 8)


def test_zero_sweeps_return_the_panel():
    a = torch.from_numpy(_panel("full", 20, 6))
    ar, v, off = k3._jacobi_svd_block_plain_f64(a, 0, 2)
    assert torch.equal(ar, a) and torch.equal(v, torch.eye(6).double())
    assert float(off) == float("inf")


def test_supports():
    f = k3.supports
    f64 = torch.float64
    assert f(1000, 64, f64)  # BASELINE config 1, 545 KB
    assert f(1024, 42, f64)  # Bᵀ of the f64 randomized fit
    assert f(256, 256, f64)  # R of a tall 256-wide QR, a 256×256 Gram
    assert f(512, 512, f64)  # exactly 4 MiB of panel and V
    assert f(2, 2, f64) and f(3, 3, f64)
    assert not f(513, 512, f64)  # past 4 MiB
    assert not f(600, 513, f64)  # n_pad 514 > 512
    assert not f(200_000, 256, f64)  # tall: the QR route's
    assert not f(1000, 64, torch.float32)
    assert not f(1000, 1, f64)
    assert not f(40, 41, f64)  # caller orients m >= n


@pytest.mark.parametrize(
    "m,n,want",
    [
        (42, 42, (21, 1, 1, 42)),         # the Gram recovery's eigh: one CTA
        (256, 256, (8, 16, 1, 256)),      # the tall fit's R and the Gram
        (1000, 64, (3, 11, 1, 1000)),     # BASELINE config 1
        (1024, 42, (3, 7, 1, 1024)),      # Bᵀ of the f64 randomized fit
        (512, 512, (5, 52, 1, 512)),      # the largest n_pad
        (262_142, 2, (1, 1, 30, 8740)),   # the tallest panel: rows split
        (100_000, 4, (2, 1, 24, 4168)),
        (7876, 65, (1, 33, 1, 7876)),     # 2w = 2 holds the most rows a CTA
        (10_000, 50, (13, 2, 23, 436)),   # n_pad > 48 past 8960 rows: both
    ],
)
def test_plan_of_the_served_panels(m, n, want):
    assert k3.plan(m, n) == want


def test_plan_serves_the_tallest_panel_of_every_width():
    """The tallest panel supports() takes at each n gets a plan, and so,
    since a plan that fits m rows also fits fewer, every panel does."""
    for n in range(2, 513):
        n_pad = n + n % 2
        m_max = (4 << 20) // (8 * n_pad) - n_pad
        if m_max >= n:
            w, p, r, mr = k3.plan(m_max, n)
            assert 2 * w * p >= n and r * mr >= m_max


def _corners(n):
    """Panels at the edges of supports() for n columns: square, the
    tallest, and around the heights where one CTA stops holding the
    panel, and where one CTA stops holding the rows of a block pair of
    2, 4 or n_pad columns."""
    n_pad = n + n % 2
    m_max = (4 << 20) // (8 * n_pad) - n_pad
    edges = [n, m_max, (n + m_max) // 2]
    for w2 in {2, 4, min(n_pad, k3.MAX_W2)}:
        rpt = k3.rows_per_thread(w2)
        tj = k3._warps(w2)
        edge = (k3.MAX_THREADS - tj) * rpt
        edges += [edge - 1, edge, edge + 1, edge + 2]
    return sorted({m for m in edges if n <= m <= m_max})


@pytest.mark.parametrize("n", [2, 3, 4, 7, 36, 42, 43, 48, 49, 50, 57, 58,
                               64, 65, 120, 121, 255, 256, 300, 511, 512])
def test_plan_fits_a_cta_at_every_corner(n):
    """Every panel supports() takes gets a plan whose CTA holds its rows
    in registers (at most rows_per_thread rows a thread, within the
    threads the kernel's registers allow) and its block pair, J and
    partial sums in 227 KB of shared memory (less 1 KB), and whose grid
    fits an H100's 132 SMs."""
    n_pad = n + n % 2
    for m in _corners(n):
        assert k3.supports(m, n, torch.float64)
        w, p, r, mr = k3.plan(m, n)
        n2 = 2 * w * p
        assert n2 >= n and n2 - n < 2 * p  # at most one column a block
        assert mr % 2 == 0 and r * mr >= m and r * mr - m < 2 * r
        assert 2 * w <= k3.MAX_W2 == 48
        rpt, ta, tj = k3.threads(2 * w, mr)
        assert ta % 32 == 0 and tj % 32 == 0
        assert rpt <= k3.rows_per_thread(2 * w)
        assert ta * rpt >= mr and tj >= 2 * w
        assert ta + tj <= k3.MAX_THREADS == 256
        ld = mr if p == 1 else max(mr, n2)
        assert k3.smem_bytes(ld, 2 * w, ta, tj) <= k3.SMEM_BUDGET
        assert k3.SMEM_BUDGET <= 232_448 - 1024
        assert p * r <= k3.MAX_CTAS
        if p == 1:
            assert 2 * w == n_pad


def test_wrapper_on_a_panel_split_by_blocks_and_rows():
    """10000×50: no block pair's rows fit one CTA and 2w = 50 is past
    the widest instantiation, so the plan splits both columns (P = 2) and
    rows (R = 23); on the CPU the wrapper runs the block plain version,
    against LAPACK in the JAX kernel test's bands."""
    a = _panel("full", 10_000, 50)
    ar, v, off = k3.jacobi_svd_vmem_f64(torch.from_numpy(a))
    s, us, vv = _factors(ar.numpy(), v.numpy())
    _check_factors(a, s, us, vv, np.linalg.svd(a, compute_uv=False))
    assert float(off) <= k3._tol(10_000, 50)


@pytest.mark.parametrize(
    "w2,rows,want",
    [
        (2, 8960, (40, 224, 32)),   # the tallest rows a CTA holds at 2w = 2
        (2, 8961, None),
        (16, 256, (3, 96, 32)),     # the most rows a thread may hold
        (42, 42, (1, 64, 64)),      # one row a thread at 2w > 30
        (12, 1024, (5, 224, 32)),   # five rows a thread for 1024 rows
        (48, 192, (1, 192, 64)),
        (48, 200, None),            # 200 rows of 48 columns: too many
    ],
)
def test_threads(w2, rows, want):
    assert k3.threads(w2, rows) == want


@pytest.mark.parametrize(
    "shape,dtype,err",
    [
        ((64, 8), torch.float32, TypeError),
        ((8,), torch.float64, ValueError),
        ((200_000, 4), torch.float64, ValueError),
        ((8, 9), torch.float64, ValueError),
    ],
)
def test_wrapper_rejects(shape, dtype, err):
    with pytest.raises(err):
        k3.jacobi_svd_vmem_f64(torch.zeros(shape, dtype=dtype))


def test_other_devices_never_take_the_plain_version():
    with pytest.raises(ValueError, match="unsupported device"):
        k3.jacobi_svd_vmem_f64(
            torch.empty((64, 8), dtype=torch.float64, device="meta")
        )


# -- the routes that run K3, through its block plain version ----------

def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-300)


@pytest.mark.parametrize(
    "route,shape,k",
    [("k3", (120, 10), 4), ("k3", (90, 31), 8), ("qr_k3", (600, 12), 5),
     ("qr_k3", (400, 33), 6)],
)
def test_k3_routes_match_jax_pca(monkeypatch, route, shape, k):
    """An exact float64 fit whose SVD takes the ``k3`` or ``qr_k3`` rung
    (forced here on the CPU, where the wrapper runs the block plain
    version) against the JAX package's Pca at 1e-10."""
    calls = []
    real = k3._jacobi_svd_block_plain_f64

    def counted(a, max_sweeps, w):
        calls.append(tuple(a.shape))
        return real(a, max_sweeps, w)

    monkeypatch.setattr(k3, "_jacobi_svd_block_plain_f64", counted)
    monkeypatch.setattr(jacobi, "_route", lambda m, n, dtype, dev: route)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape) * np.linspace(1, 5, shape[1]) + 2.0
    mj = jpd.Pca(k)
    yj = np.asarray(mj.fit_transform(x))
    m = pt.Pca(k, device="cpu", solver="full")
    y = m.fit_transform(x).numpy()
    n = shape[1]
    assert calls == [(n, n) if route == "qr_k3" else shape]
    assert _rel(y, yj) < 1e-10
    assert _rel(m.components_.numpy(), np.asarray(mj.components_)) < 1e-10
    assert _rel(m.singular_values_.numpy(),
                np.asarray(mj.singular_values_)) < 1e-10
    assert _rel(m.inverse_transform(y).numpy(),
                np.asarray(mj.inverse_transform(yj))) < 1e-10


@pytest.mark.parametrize(
    "n,r", [(16, 16), (20, 5), (9, 9), (42, 42), (42, 30)]
)
def test_eigh_psd_k3_matches_jax(n, r):
    """``_eigh_psd_k3`` (K3's block plain version on the CPU) against the
    JAX package's ``eigh_psd_jit_cert`` at 1e-10: λ relative to λ_max,
    eigenvectors of the resolved spectrum with signs aligned."""
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    b = rng.standard_normal((n, r)) * np.linspace(1, 6, r)
    g = b @ b.T
    w, v, off = linalg._eigh_psd_k3(torch.from_numpy(g))
    w_j, v_j, _ = jax_linalg.eigh_psd_jit_cert(jnp.asarray(g))
    w_j, v_j = np.asarray(w_j), np.asarray(v_j)
    assert np.abs(w.numpy() - w_j).max() / w_j[-1] < 1e-10
    top = slice(n - r, n)
    sign = np.sign((v.numpy()[:, top] * v_j[:, top]).sum(0))
    assert np.abs(v.numpy()[:, top] - v_j[:, top] * sign).max() < 1e-10
    assert float(off) <= linalg.convergence_tol(torch.float64, n)


# -- on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(a, run, w):
    """K3 on ``a`` (a CUDA tensor) against its block plain version at
    block width ``w`` and against LAPACK; one call, one launch."""
    m, n = a.shape
    before = k3.launches
    ar, v, off = run(a)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ar_p, v_p, off_p = k3._jacobi_svd_block_plain_f64(a, 30, w)
    a_np = a.cpu().numpy()
    s, us, vv = _factors(ar.cpu().numpy(), v.cpu().numpy())
    s_p, _, _ = _factors(ar_p.cpu().numpy(), v_p.cpu().numpy())
    s_ref = np.linalg.svd(a_np, compute_uv=False)
    _check_factors(a_np, s, us, vv, s_ref)
    assert np.abs(s - s_p).max() / s_ref[0] < 1e-11
    assert float(off) <= k3._tol(m, n) and float(off_p) <= k3._tol(m, n)


def _forced(monkeypatch, w, p, r, m):
    """Make the wrapper use block plan (w, P, R) on an m-row panel."""
    mr = -(-m // r)
    mr += mr % 2
    monkeypatch.setattr(k3, "plan", lambda m_, n_: (w, p, r, mr))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n,w", BLOCK_CASES)
def test_kernel_matches_block_plain_on_small_panels(cuda_device, monkeypatch,
                                                    kind, m, n, w):
    """The CPU cases: P = 1 where w is None, else the block plan the
    case names, forced on the wrapper."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    if w is not None:
        _forced(monkeypatch, w, -(-n // (2 * w)), 1, m)
    _check_kernel(a, k3.jacobi_svd_vmem_f64, k3.plan(m, n)[0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n,w,p,r",
    [("full", 90, 9, 5, 1, 3), ("zerocol", 301, 12, 6, 1, 4),
     ("rankdef", 64, 10, 5, 1, 2), ("full", 90, 9, 2, 3, 3),
     ("zerocol", 301, 12, 3, 2, 4), ("rankdef", 64, 10, 1, 5, 2)],
)
def test_kernel_rows_split_on_small_panels(cuda_device, monkeypatch, kind, m,
                                           n, w, p, r):
    """The row split (R > 1) that the plan keeps for panels beyond ~9k
    rows, with one block pair (P = 1) and with several, forced on small
    panels."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    _forced(monkeypatch, w, p, r, m)
    _check_kernel(a, k3.jacobi_svd_vmem_f64, w)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n",
    [("full", 1024, 42), ("full", 1000, 64), ("full", 33, 7),
     ("full", 256, 256), ("rankdef", 1000, 64), ("full", 100_000, 4),
     ("full", 20_000, 8), ("full", 10_000, 50)],
)
def test_kernel_matches_plain_on_card(cuda_device, kind, m, n):
    """Served shapes under the wrapper's own plan, the row-split tall
    panels included."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    _check_kernel(a, k3.jacobi_svd_vmem_f64, k3.plan(m, n)[0])


@pytest.mark.cuda
def test_exact_f64_pca_on_a_panel_split_by_blocks_and_rows(cuda_device):
    """Exact float64 Pca of a 10000×50 table runs K3 directly (the k3
    rung, plan P = 2 and R = 23) and matches LAPACK's SVD at 1e-10."""
    rng = np.random.default_rng(13)
    x = rng.standard_normal((10_000, 50)) * np.linspace(1, 5, 50) + 2.0
    assert jacobi._route(10_000, 50, torch.float64, "cuda") == "k3"
    before = k3.launches
    model = pt.Pca(50, device="cuda")
    y = model.fit_transform(torch.from_numpy(x).to(cuda_device))
    assert k3.launches == before + 1
    xc = x - x.mean(0)
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    u, vt = linalg.svd_flip(torch.from_numpy(u), torch.from_numpy(vt))
    assert _rel(model.singular_values_.cpu().numpy(), s) < 1e-10
    assert _rel(y.cpu().numpy(), (u * torch.from_numpy(s)).numpy()) < 1e-10


@pytest.fixture(scope="module")
def smoke_panels():
    """The panels ``chip_smoke.py`` times K3 on: the 256×256 R and Gram
    of the exact float64 fit, BASELINE config 1's centered 1000×64, Bᵀ
    1024×42 of the float64 randomized fit, the 42×42 eigh of its
    zero-pass Gram recovery, config 3's 64×64 FastIca whitening Gram and
    a 10000×50 panel split by blocks and rows."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    return cs.k3_panels(pt, k3, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["r_factor_256x256", "psd_gram_256x256",
                                  "config1_centered_1000x64", "bt_1024x42",
                                  "gram_recovery_eigh_42x42",
                                  "split_10000x50", "fast_ica_gram_64x64"])
def test_kernel_matches_block_plain_on_smoke_panels(smoke_panels, name):
    a = smoke_panels[name]
    _check_kernel(a, k3.jacobi_svd_vmem_f64, k3.plan(*a.shape)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k2", "k3"])
def test_kernel_non_finite_panel_never_certifies(cuda_device, kernel):
    """The kernels' convergence maxima propagate NaN, as the TPU
    kernels' ``jnp.maximum`` does."""
    a = _panel("nan", 40, 8)
    if kernel == "k3":
        run, tol = k3.jacobi_svd_vmem_f64, k3._tol(40, 8)
    else:
        run, tol = k2.jacobi_svd_vmem, k2._tol(40, 8)
        a = a.astype(np.float32)
    _, _, off = run(torch.from_numpy(a).to(cuda_device))
    torch.cuda.synchronize()
    assert not float(off) <= tol


@pytest.mark.cuda
def test_kernel_non_finite_panel_never_certifies_across_ctas(cuda_device,
                                                             monkeypatch):
    a = torch.from_numpy(_panel("nan", 40, 8)).to(cuda_device)
    _forced(monkeypatch, 2, 2, 1, 40)
    _, _, off = k3.jacobi_svd_vmem_f64(a)
    torch.cuda.synchronize()
    assert not float(off) <= k3._tol(40, 8)


@pytest.mark.cuda
def test_kernel_zero_sweeps(cuda_device, monkeypatch):
    a = torch.from_numpy(_panel("full", 20, 6)).to(cuda_device)
    for plan in ((3, 1, 1, 20), (1, 3, 1, 20)):
        monkeypatch.setattr(k3, "plan", lambda m, n, plan=plan: plan)
        ar, v, off = k3.jacobi_svd_vmem_f64(a, max_sweeps=0)
        assert torch.equal(ar, a) and float(off) == float("inf")
        assert torch.equal(v, torch.eye(6, dtype=a.dtype, device=a.device))


@pytest.mark.cuda
def test_grid_too_large_raises(cuda_device, monkeypatch):
    """A plan whose grid cannot be co-resident raises; nothing falls
    back."""
    a = torch.from_numpy(_panel("full", 512, 512)).to(cuda_device)
    # 8960 rows of two columns: 256 threads at 255 registers, one CTA an
    # SM, so 300 CTAs cannot be co-resident on 132 SMs.
    monkeypatch.setattr(k3, "plan", lambda m, n: (1, 300, 1, 8960))
    with pytest.raises(RuntimeError, match="cooperative"):
        k3.jacobi_svd_vmem_f64(a)
