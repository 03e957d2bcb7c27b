"""K2, the float32 one-sided Jacobi SVD kernel: its plain versions (the
TPU kernel's order and the block schedule of the Hopper kernel) against
the JAX Pallas kernel under the TPU interpreter, its pair schedule, the
wrapper's reach, block plan and checks, the build key, and (on a CUDA
card) the hand-written kernel against its block plain version."""

import itertools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petal_decomposition_tpu.ops.pallas import jacobi_kernels as jax_k2
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops.kernels import _build
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32


def _panel(kind, m, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "rankdef":
        a = rng.standard_normal((m, 3)) @ rng.standard_normal((3, n))
    elif kind == "nan":
        a = rng.standard_normal((m, n))
        a[m // 2, 1] = np.nan
    else:
        a = rng.standard_normal((m, n)) @ np.diag(np.linspace(1, 10, n))
    return a.astype(np.float32)


def _factors(a_rot, v):
    """Sorted σ, U·σ and Vᵀ from a (columns uᵢσᵢ, V) pair."""
    a_rot = np.asarray(a_rot, np.float64)
    v = np.asarray(v, np.float64)
    s = np.linalg.norm(a_rot, axis=0)
    order = np.argsort(-s, kind="stable")
    return s[order], a_rot[:, order], v[:, order].T


def _vector_band(n):
    """The band of V's orthogonality and of the reconstruction: 1e-5 up
    to 64 columns, then growing as √n, since the rounding of the
    ≈ n·sweeps rotations each column of V sees adds up as a random walk
    (``chip_smoke.py`` measures 1.0e-5 on a 256×256 and 2.1e-5 on a
    632×632 R on the card)."""
    return 1e-5 * max(1.0, (n / 64) ** 0.5)


def _check_factors(a, s, us, vt, s_ref):
    """The float32 band, 1e-5: σ against float64 LAPACK relative to σ₁,
    reconstruction A = (U·σ)·Vᵀ relative to max|A| and orthogonal V
    within :func:`_vector_band`."""
    n = a.shape[1]
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-5
    assert np.abs(us @ vt - a).max() / np.abs(a).max() < _vector_band(n)
    assert np.abs(vt @ vt.T - np.eye(n)).max() < _vector_band(n)


def _jax_kernel(a):
    import jax.numpy as jnp

    with pltpu.force_tpu_interpret_mode():
        ar_j, v_j, off_j = jax_k2.jacobi_svd_vmem(jnp.asarray(a))
    return ar_j, v_j, float(off_j)


def _check_against_jax(a, ar, v, off):
    """Factors against LAPACK in the float32 band, σ against the JAX
    kernel's; both converge under the kernel's own tolerance."""
    m, n = a.shape
    assert ar.shape == (m, n) and v.shape == (n, n) and off.shape == ()
    assert ar.dtype == F32 and v.dtype == F32
    ar_j, v_j, off_j = _jax_kernel(a)
    s, us, vt = _factors(ar.numpy(), v.numpy())
    s_j, _, _ = _factors(ar_j, v_j)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    _check_factors(a, s, us, vt, s_ref)
    assert np.abs(s - s_j).max() / s_ref[0] < 1e-5
    tol = k2._tol(m, n)
    assert float(off) <= tol and off_j <= tol


@pytest.mark.parametrize(
    "kind,m,n",
    [
        ("full", 64, 8),      # even n
        ("full", 33, 7),      # odd n: one zero column
        ("rankdef", 40, 10),  # rank-deficient
        ("full", 256, 43),    # the flagship panel's width
    ],
)
def test_plain_matches_jax_kernel(kind, m, n):
    """The wrapper's CPU route (the block plain version at the plan's
    block width) against the JAX kernel."""
    a = _panel(kind, m, n)
    _check_against_jax(a, *k2.jacobi_svd_vmem(torch.from_numpy(a)))


def test_tpu_order_plain_matches_jax_kernel():
    a = _panel("full", 256, 43)
    _check_against_jax(a, *k2._jacobi_svd_plain(torch.from_numpy(a), 30))


# (kind, m, n, w, P, R): w None is the wrapper's plan, whose (P, R) the
# case names.
BLOCK_CASES = [
    ("full", 50, 8, None, 1, 1),      # P = 1: the single-CTA case
    ("full", 50, 8, 2, 2, 1),         # P = 2
    ("full", 33, 7, 2, 2, 1),         # odd n, P = 2: one padding column
    ("full", 45, 13, 3, 3, 1),        # n not a multiple of 2w: 5 padding
    ("full", 64, 64, 8, 4, 1),        # square, P = 4
    ("full", 30, 29, 1, 15, 1),       # w = 1: 29 outer steps of one pair
    ("full", 1024, 43, None, 2, 1),   # the flagship panel: P = 2 by plan
    ("full", 3125, 4, None, 1, 1),    # the tallest 4-column panel in reach
    ("rankdef", 40, 10, None, 1, 1),
    ("rankdef", 40, 10, 2, 3, 1),
]


@pytest.mark.parametrize("kind,m,n,w,p,r", BLOCK_CASES)
def test_block_plain_matches_jax_kernel(kind, m, n, w, p, r):
    a = _panel(kind, m, n)
    if w is None:
        assert k2.plan(m, n)[1:3] == (p, r)
        out = k2.jacobi_svd_vmem(torch.from_numpy(a))  # the CPU route
    else:
        assert -(-n // (2 * w)) == p
        out = k2._jacobi_svd_block_plain(torch.from_numpy(a), 30, w)
    _check_against_jax(a, *out)


def test_wrapper_runs_the_block_plain_version_on_the_cpu():
    a = torch.from_numpy(_panel("full", 40, 9))
    ar, v, off = k2.jacobi_svd_vmem(a)
    ar2, v2, off2 = k2._jacobi_svd_block_plain(a, 30, k2.plan(40, 9)[0])
    assert torch.equal(ar, ar2) and torch.equal(v, v2)
    assert float(off) == float(off2)


def test_constants_are_the_tpu_kernels():
    """Skip and stop at float32's unit roundoff, the stop threshold
    eps·√max(m, n_pad) of the JAX kernel (``_jacobi_svd_vmem``)."""
    assert k2.EPS == float(np.finfo(np.float32).eps)
    for m, n in ((1024, 43), (40, 41), (7, 7)):
        n_pad = n + n % 2
        want = float(np.finfo(np.float32).eps) * float(np.sqrt(max(m, n_pad)))
        assert k2._tol(m, n) == want


@pytest.mark.parametrize("w", [None, 1, 2, 3])
def test_non_finite_panel_never_certifies(w):
    a = torch.from_numpy(_panel("nan", 40, 8))
    if w is None:
        _, _, off = k2.jacobi_svd_vmem(a)
    else:
        _, _, off = k2._jacobi_svd_block_plain(a, 30, w)
    assert not float(off) <= k2._tol(40, 8)


def test_zero_sweeps_return_the_panel():
    a = torch.from_numpy(_panel("full", 20, 6))
    ar, v, off = k2._jacobi_svd_block_plain(a, 0, 2)
    assert torch.equal(ar, a) and torch.equal(v, torch.eye(6))
    assert float(off) == float("inf")


def test_pair_table_covers_every_pair_each_sweep():
    for n_pad in (2, 4, 8, 44):
        table = k2.pair_table(n_pad)
        h = n_pad // 2
        assert table.shape == (n_pad - 1, n_pad)
        seen = set()
        for row in table:
            assert sorted(row) == list(range(n_pad))  # a perfect matching
            seen |= {frozenset(p) for p in zip(row[:h], row[h:])}
        assert seen == {
            frozenset(p) for p in itertools.combinations(range(n_pad), 2)
        }


def test_pair_table_follows_the_tpu_permutation():
    """Row s is the position→column map after s advances of the JAX
    kernel's static step permutation."""
    n = 10
    perm, _ = jax_k2._tournament_perms(n)
    pos = np.arange(n)
    for row in k2.pair_table(n):
        np.testing.assert_array_equal(row, pos)
        pos = pos[perm]
    np.testing.assert_array_equal(pos, np.arange(n))  # one full cycle


# -- reach and block plan --------------------------------------------------

def test_supports():
    """The JAX kernel's gate, m·max(n_pad, 128) ≤ 400,000."""
    f = k2.supports
    assert f(1024, 43, F32)  # the flagship panel
    assert f(1024, 44, F32)
    assert f(3125, 64, F32) and not f(3126, 64, F32)
    assert not f(4096, 64, F32)  # the QR route's
    assert f(1000, 64, F32)  # BASELINE config 1's shape
    assert f(632, 632, F32)  # the largest R, 3.2 MB of panel and V
    assert not f(633, 632, F32)
    assert f(1333, 300, F32) and not f(1334, 300, F32)
    assert f(3125, 2, F32) and not f(3126, 2, F32)
    assert not f(634, 633, F32)  # n_pad 634 > 632
    assert not f(200_000, 256, F32)  # tall: the QR route's
    assert not f(1024, 43, torch.float64)
    assert not f(1024, 1, F32)
    assert not f(40, 41, F32)  # caller orients m >= n


def _old_port_gate(m, n):
    """One CTA's shared memory holding the padded panel, V and two
    values a column (the one-block kernel this kernel replaced)."""
    n_pad = n + n % 2
    return 4 * (n_pad * m + n_pad * n_pad + 2 * n_pad) <= 232_448 - 1024


def _widths():
    return sorted(set(range(2, 140)) | set(range(140, 700, 7))
                  | {166, 167, 168, 169, 255, 256, 631, 632, 633, 634})


def test_supports_covers_the_jax_and_old_port_gates():
    """K2's reach is the JAX kernel's gate, at its edges and around the
    port's old one-block gate; a panel the old gate admitted past the JAX
    gate (28,924×2, say) takes QR + K2 on its R, as in the JAX
    package."""
    from petal_decomposition_tpu_torch.ops.jacobi import _route

    for n in _widths():
        n_pad = n + n % 2
        heights = {n, n + 1, 1000, 1024, 3125, 3126, 10_000, 28_924, 28_925,
                   400_000 // max(n_pad, 128),
                   400_000 // max(n_pad, 128) + 1,
                   (232_448 - 1024) // (4 * n_pad) - n_pad - 2}
        for m in sorted(h for h in heights if h >= n):
            gate = bool(jax_k2.supports(m, n, np.float32))
            assert k2.supports(m, n, F32) is gate, (m, n)
            if _old_port_gate(m, n) and not gate:
                assert _route(m, n, F32, "cuda") == "qr_k2", (m, n)


@pytest.mark.parametrize(
    "m,n,want",
    [
        (1024, 43, (11, 2, 1, 1024)),     # Bᵀ of the f32 randomized fit
        (64, 64, (16, 2, 1, 64)),         # R of the exact 1M×64 fit
        (1000, 64, (8, 4, 1, 1000)),      # direct: BASELINE config 1's shape
        (256, 256, (16, 8, 1, 256)),      # R of the exact 200k×256 fit
        (632, 632, (8, 40, 1, 632)),      # the widest R
        (3125, 128, (4, 16, 1, 3126)),    # the gate's tallest at 128
        (3125, 2, (1, 1, 1, 3126)),       # the tallest panel
        (3125, 4, (2, 1, 1, 3126)),
        (3125, 16, (4, 2, 1, 3126)),
        (1332, 300, (4, 38, 1, 1332)),
    ],
)
def test_plan_of_the_served_panels(m, n, want):
    assert k2.plan(m, n) == want


def _tallest(n):
    """The most rows supports() takes at n columns."""
    return 400_000 // max(n + n % 2, 128)


def test_plan_serves_the_tallest_panel_of_every_width():
    """The tallest panel supports() takes at each n gets a plan, with
    every block pair's rows in one CTA (R = 1), and so, since a plan that
    fits m rows also fits fewer, every panel does."""
    for n in range(2, 633):
        m_max = _tallest(n)
        if m_max >= n:
            w, p, r, mr = k2.plan(m_max, n)
            assert 2 * w * p >= n and r * mr >= m_max
            assert p * r <= k2.MAX_CTAS and r == 1


def _corners(n):
    """Panels at the edges of supports() for n columns: square, the
    tallest, and around the heights where one CTA stops holding the
    panel, and where one CTA stops holding the rows of a block pair of
    2, 4 or n_pad columns."""
    n_pad = n + n % 2
    m_max = _tallest(n)
    edges = [n, m_max, (n + m_max) // 2]
    for w2 in {2, 4, min(n_pad, k2.MAX_W2)}:
        rpt = k2.rows_per_thread(w2)
        tj = k2._warps(w2)
        edge = (k2.MAX_THREADS - tj) * rpt
        edges += [edge - 1, edge, edge + 1, edge + 2]
    return sorted({m for m in edges if n <= m <= m_max})


@pytest.mark.parametrize("n", [2, 3, 4, 7, 36, 42, 43, 48, 49, 50, 57, 58,
                               64, 65, 110, 120, 128, 255, 256, 300, 511,
                               512, 631, 632])
def test_plan_fits_a_cta_at_every_corner(n):
    """Every panel supports() takes gets a plan whose CTA holds its rows
    in registers (at most rows_per_thread rows a thread, within the
    threads the kernel's registers allow) and its block pair, J and
    partial sums in 227 KB of shared memory (less 1 KB), and whose grid
    fits an H100's 132 SMs."""
    n_pad = n + n % 2
    for m in _corners(n):
        assert k2.supports(m, n, F32)
        w, p, r, mr = k2.plan(m, n)
        n2 = 2 * w * p
        assert n2 >= n and n2 - n < 2 * p  # at most one column a block
        assert mr % 2 == 0 and r * mr >= m and r * mr - m < 2 * r
        assert 2 * w <= k2.MAX_W2 == 48
        rpt, ta, tj = k2.threads(2 * w, mr)
        assert ta % 32 == 0 and tj % 32 == 0
        assert rpt <= k2.rows_per_thread(2 * w)
        assert ta * rpt >= mr and tj >= 2 * w
        assert ta + tj <= k2.MAX_THREADS == 256
        ld = mr if p == 1 else max(mr, n2)
        assert k2.smem_bytes(ld, 2 * w, ta, tj) <= k2.SMEM_BUDGET
        assert k2.SMEM_BUDGET <= 232_448 - 1024
        assert p * r <= k2.MAX_CTAS
        if p == 1:
            assert 2 * w == n_pad


@pytest.mark.parametrize(
    "w2,rows,want",
    [
        (2, 13_440, (60, 224, 32)),  # the tallest rows a CTA holds at 2w = 2
        (2, 13_441, None),
        (4, 6720, (30, 224, 32)),
        (16, 256, (7, 64, 32)),      # the most rows a thread may hold
        (44, 1024, None),            # the flagship width in one CTA: no
        (22, 1024, (5, 224, 32)),
        (48, 384, (2, 192, 64)),
        (48, 385, None),
    ],
)
def test_threads(w2, rows, want):
    """Up to twice K3's rows a thread at the same registers (a float
    takes one 32-bit register, a double two), at most 120 registers of
    rows (more spilled at 2w ≤ 8)."""
    assert k2.threads(w2, rows) == want


@pytest.mark.parametrize(
    "shape,dtype,err",
    [
        ((64, 8), torch.float64, TypeError),
        ((8,), F32, ValueError),
        ((5000, 700), F32, ValueError),
        ((8, 9), F32, ValueError),
    ],
)
def test_wrapper_rejects(shape, dtype, err):
    with pytest.raises(err):
        k2.jacobi_svd_vmem(torch.zeros(shape, dtype=dtype))


def test_other_devices_never_take_the_plain_version():
    with pytest.raises(ValueError, match="unsupported device"):
        k2.jacobi_svd_vmem(torch.empty((64, 8), device="meta"))


def test_build_digest_covers_shared_headers(tmp_path, monkeypatch):
    """A library's build key changes with its own source and with every
    shared ``.cuh`` header, so an edited header rebuilds K2 and K3."""
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "b.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build.digest((s,)) for s in ("a.cu", "b.cu")}
    assert before["a.cu"] != before["b.cu"]  # the name is part of the key
    assert _build.digest(("a.cu",)) == before["a.cu"]  # and it is stable
    (tmp_path / "shared.cuh").write_text("// two\n")
    after = {s: _build.digest((s,)) for s in ("a.cu", "b.cu")}
    assert all(after[s] != before[s] for s in after)
    (tmp_path / "a.cu").write_text('#include "shared.cuh"\n// edited\n')
    assert _build.digest(("a.cu",)) != after["a.cu"]
    assert _build.digest(("b.cu",)) == after["b.cu"]


def test_the_kernels_sources_share_one_header():
    """K2's and K3's sources are instances of one block Jacobi."""
    for src in ("jacobi_svd.cu", "jacobi_svd_f64.cu"):
        text = (_build.CSRC / src).read_text()
        assert '#include "jacobi_block.cuh"' in text
        assert "__global__" not in text


# -- on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(a, w):
    """K2 on ``a`` (a CUDA tensor) against its block plain version at
    block width ``w`` and against float64 LAPACK, in the float32 band;
    one call, one launch."""
    m, n = a.shape
    before = k2.launches
    ar, v, off = k2.jacobi_svd_vmem(a)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ar_p, v_p, off_p = k2._jacobi_svd_block_plain(a, 30, w)
    a_np = a.cpu().numpy()
    s, us, vt = _factors(ar.cpu().numpy(), v.cpu().numpy())
    s_p, _, _ = _factors(ar_p.cpu().numpy(), v_p.cpu().numpy())
    s_ref = np.linalg.svd(a_np.astype(np.float64), compute_uv=False)
    _check_factors(a_np, s, us, vt, s_ref)
    assert np.abs(s - s_p).max() / s_ref[0] < 1e-5
    assert float(off) <= k2._tol(m, n) and float(off_p) <= k2._tol(m, n)


def _forced(monkeypatch, w, p, r, m):
    """Make the wrapper use block plan (w, P, R) on an m-row panel."""
    mr = -(-m // r)
    mr += mr % 2
    monkeypatch.setattr(k2, "plan", lambda m_, n_: (w, p, r, mr))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,n,w,p,r", BLOCK_CASES)
def test_kernel_matches_block_plain_on_small_panels(cuda_device, monkeypatch,
                                                    kind, m, n, w, p, r):
    """The CPU cases: the wrapper's plan where w is None, else the block
    plan the case names, forced on the wrapper."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    if w is not None:
        _forced(monkeypatch, w, p, 1, m)
    _check_kernel(a, k2.plan(m, n)[0])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n,w,p,r",
    [("full", 90, 9, 5, 1, 3), ("rankdef", 64, 10, 5, 1, 2),
     ("full", 90, 9, 2, 3, 3), ("full", 301, 12, 3, 2, 4),
     ("rankdef", 64, 10, 1, 5, 2)],
)
def test_kernel_rows_split_on_small_panels(cuda_device, monkeypatch, kind, m,
                                           n, w, p, r):
    """The row split (R > 1), with one block pair and with several,
    forced on small panels."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    _forced(monkeypatch, w, p, r, m)
    _check_kernel(a, w)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n",
    [("full", 1024, 43), ("full", 1024, 44), ("rankdef", 512, 20),
     ("full", 1000, 64), ("full", 256, 256), ("full", 632, 632),
     ("full", 3125, 128), ("full", 3125, 4), ("full", 1332, 300),
     ("full", 3125, 2)],
)
def test_kernel_matches_plain_on_card(cuda_device, kind, m, n):
    """Served shapes under the wrapper's own plan, the tallest panels
    within reach included; up to 64 columns the TPU kernel's order agrees on σ
    too (wider, its c = 1 drift leaves the float32 band: 2.9e-5 of σ₁
    on the 256×256 panel here)."""
    a = torch.from_numpy(_panel(kind, m, n)).to(cuda_device)
    _check_kernel(a, k2.plan(m, n)[0])
    if n <= 64 and m * n <= 300_000:
        s_ref = np.linalg.svd(_panel(kind, m, n).astype(np.float64),
                              compute_uv=False)
        ar_t, v_t, _ = k2._jacobi_svd_plain(a, 30)
        s_t, _, _ = _factors(ar_t.cpu().numpy(), v_t.cpu().numpy())
        assert np.abs(s_t - s_ref).max() / s_ref[0] < 1e-5


@pytest.fixture(scope="module")
def smoke_panels():
    """The panels ``chip_smoke.py`` times K2 on (``chip_smoke.k2_panels``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    return cs.k2_panels(pt, k2, torch.device("cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["bt_1024x43", "r_factor_64x64",
                                  "config1_f32_1000x64", "r_factor_256x256",
                                  "r_factor_632x632",
                                  "fast_ica_r_factor_64x64"])
def test_kernel_matches_block_plain_on_smoke_panels(smoke_panels, name):
    a = smoke_panels[name]
    _check_kernel(a, k2.plan(*a.shape)[0])


@pytest.mark.cuda
def test_kernel_non_finite_panel_never_certifies_across_ctas(cuda_device,
                                                             monkeypatch):
    a = torch.from_numpy(_panel("nan", 40, 8)).to(cuda_device)
    for plan in ((2, 2, 1), (4, 1, 2), (1, 4, 3)):
        _forced(monkeypatch, *plan, 40)
        _, _, off = k2.jacobi_svd_vmem(a)
        torch.cuda.synchronize()
        assert not float(off) <= k2._tol(40, 8)


@pytest.mark.cuda
def test_kernel_zero_sweeps(cuda_device, monkeypatch):
    a = torch.from_numpy(_panel("full", 20, 6)).to(cuda_device)
    for plan in ((3, 1, 1, 20), (1, 3, 1, 20)):
        monkeypatch.setattr(k2, "plan", lambda m, n, plan=plan: plan)
        ar, v, off = k2.jacobi_svd_vmem(a, max_sweeps=0)
        assert torch.equal(ar, a) and float(off) == float("inf")
        assert torch.equal(v, torch.eye(6, dtype=a.dtype, device=a.device))


@pytest.mark.cuda
def test_svd_dispatch_on_card(cuda_device):
    """float32 panels within reach go to the kernel, directly or on the
    R factor of a tall QR; one beyond both goes to cuSOLVER; all factor
    the panel."""
    from petal_decomposition_tpu_torch.ops.jacobi import jacobi_svd

    for (m, n), launched in (((43, 1024), 1), ((64, 4096), 1),
                             ((64, 20_000), 1), ((634, 1000), 0)):
        a = torch.from_numpy(_panel("full", n, m).T.copy()).to(cuda_device)
        before = k2.launches
        u, s, vt, off, _ = jacobi_svd(a)
        assert k2.launches == before + launched
        rec = (u * s) @ vt
        assert float((rec - a).abs().max() / a.abs().max()) < 1e-5
        assert float(off) <= k2._tol(n, m)
