"""K2, the one-sided Jacobi SVD kernel: the port's plain version against
the JAX Pallas kernel under the TPU interpreter, its pair schedule, the
wrapper's checks, and (on a CUDA card) the hand-written kernel against
its plain version."""

import itertools

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petal_decomposition_tpu.ops.pallas import jacobi_kernels as jax_k2
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2


def _panel(kind, m, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "rankdef":
        a = rng.standard_normal((m, 3)) @ rng.standard_normal((3, n))
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
    import jax.numpy as jnp

    a = _panel(kind, m, n)
    with pltpu.force_tpu_interpret_mode():
        ar_j, v_j, off_j = jax_k2.jacobi_svd_vmem(jnp.asarray(a))
    ar, v, off = k2.jacobi_svd_vmem(torch.from_numpy(a))
    assert ar.shape == (m, n) and v.shape == (n, n) and off.shape == ()
    s, us, vt = _factors(ar.numpy(), v.numpy())
    s_j, _, _ = _factors(ar_j, v_j)
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    # σ: both against float64 LAPACK and against each other.
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-5
    assert np.abs(s - s_j).max() / s_ref[0] < 1e-5
    # Reconstruction A = (U·σ)·Vᵀ and orthogonal V.
    assert np.abs(us @ vt - a).max() / np.abs(a).max() < 1e-5
    assert np.abs(vt @ vt.T - np.eye(n)).max() < 1e-5
    # Both converge under the kernel's own tolerance.
    tol = k2._tol(m, n)
    assert float(off) <= tol and float(off_j) <= tol


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


def test_supports():
    f = k2.supports
    assert f(1024, 43, torch.float32)  # the flagship panel, 188 KB
    assert f(1024, 44, torch.float32)
    assert not f(1024, 43, torch.float64)
    assert not f(1024, 1, torch.float32)
    assert not f(40, 41, torch.float32)  # caller orients m >= n
    assert not f(4096, 64, torch.float32)  # beyond shared memory


@pytest.mark.parametrize(
    "shape,dtype,err",
    [
        ((64, 8), torch.float64, TypeError),
        ((8,), torch.float32, ValueError),
        ((4096, 64), torch.float32, ValueError),
    ],
)
def test_wrapper_rejects(shape, dtype, err):
    with pytest.raises(err):
        k2.jacobi_svd_vmem(torch.zeros(shape, dtype=dtype))


def test_other_devices_never_take_the_plain_version():
    with pytest.raises(ValueError, match="unsupported device"):
        k2.jacobi_svd_vmem(torch.empty((64, 8), device="meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n", [("full", 1024, 43), ("full", 1024, 44), ("rankdef", 512, 20)]
)
def test_kernel_matches_plain_on_card(cuda_device, kind, m, n):
    a = _panel(kind, m, n)
    at = torch.from_numpy(a).to(cuda_device)
    before = k2.launches
    ar, v, off = k2.jacobi_svd_vmem(at)
    torch.cuda.synchronize()
    assert k2.launches == before + 1
    ar_p, v_p, _ = k2._jacobi_svd_plain(at, 30)
    s, us, vt = _factors(ar.cpu().numpy(), v.cpu().numpy())
    s_p, _, _ = _factors(ar_p.cpu().numpy(), v_p.cpu().numpy())
    s_ref = np.linalg.svd(a.astype(np.float64), compute_uv=False)
    assert np.abs(s - s_ref).max() / s_ref[0] < 1e-5
    assert np.abs(s - s_p).max() / s_ref[0] < 1e-5
    assert np.abs(us @ vt - a).max() / np.abs(a).max() < 1e-5
    assert np.abs(vt @ vt.T - np.eye(n)).max() < 1e-5
    assert float(off) <= k2._tol(m, n)


@pytest.mark.cuda
def test_svd_dispatch_on_card(cuda_device):
    """float32 panels within reach go to the kernel, directly or on the
    R factor of a tall QR; one beyond both goes to cuSOLVER; all factor
    the panel."""
    from petal_decomposition_tpu_torch.ops.jacobi import jacobi_svd

    for (m, n), launched in (((43, 1024), 1), ((64, 4096), 1),
                             ((200, 4096), 0)):
        a = torch.from_numpy(_panel("full", n, m).T.copy()).to(cuda_device)
        before = k2.launches
        u, s, vt, off, _ = jacobi_svd(a)
        assert k2.launches == before + launched
        rec = (u * s) @ vt
        assert float((rec - a).abs().max() / a.abs().max()) < 1e-5
        assert float(off) <= k2._tol(n, m)
