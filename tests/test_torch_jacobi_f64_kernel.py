"""K3, the float64 one-sided Jacobi SVD kernel: the port's plain version
against the JAX Pallas kernel (df64) under the TPU interpreter, the
wrapper's reach and checks, and (on a CUDA card) the hand-written kernel
against its plain version."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from petal_decomposition_tpu.ops.pallas import jacobi_f64_kernel as jax_k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2


def _panel(kind, m, n, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "rankdef":
        return rng.standard_normal((m, 3)) @ rng.standard_normal((3, n))
    if kind == "nan":
        a = rng.standard_normal((m, n))
        a[m // 2, 1] = np.nan
        return a
    return rng.standard_normal((m, n)) @ np.diag(np.linspace(1, 10, n))


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
    import jax.numpy as jnp

    a = _panel(kind, m, n)
    with pltpu.force_tpu_interpret_mode():
        ar_j, v_j, off_j = jax_k3.jacobi_svd_vmem_f64(jnp.asarray(a))
    ar, v, off = k3.jacobi_svd_vmem_f64(torch.from_numpy(a))
    assert ar.shape == (m, n) and v.shape == (n, n) and off.shape == ()
    assert ar.dtype == torch.float64
    s, us, vv = _factors(ar.numpy(), v.numpy())
    s_j, us_j, vv_j = _factors(ar_j, v_j)
    s_ref = np.linalg.svd(a, compute_uv=False)
    _check_factors(a, s, us, vv, s_ref)
    assert np.abs(s - s_j).max() / s_ref[0] < 1e-11
    # Vectors of the resolved directions agree once signs are aligned.
    r = 3 if kind == "rankdef" else n
    sign = np.sign((vv[:, :r] * vv_j[:, :r]).sum(0))
    assert np.abs(vv[:, :r] - vv_j[:, :r] * sign).max() < 1e-10
    assert np.abs(us[:, :r] - us_j[:, :r] * sign).max() / s_ref[0] < 1e-11
    # Both converge under the kernel's own tolerance.
    tol = k3._tol(m, n)
    assert float(off) <= tol and float(off_j) <= tol


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "kind,m,n",
    [("full", 1024, 42), ("full", 1000, 64), ("full", 33, 7),
     ("full", 256, 256), ("rankdef", 1000, 64)],
)
def test_kernel_matches_plain_on_card(cuda_device, kind, m, n):
    a = _panel(kind, m, n)
    at = torch.from_numpy(a).to(cuda_device)
    before = k3.launches
    ar, v, off = k3.jacobi_svd_vmem_f64(at)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    ar_p, v_p, _ = k3._jacobi_svd_plain_f64(at, 30)
    s, us, vv = _factors(ar.cpu().numpy(), v.cpu().numpy())
    s_p, _, _ = _factors(ar_p.cpu().numpy(), v_p.cpu().numpy())
    s_ref = np.linalg.svd(a, compute_uv=False)
    _check_factors(a, s, us, vv, s_ref)
    assert np.abs(s - s_p).max() / s_ref[0] < 1e-11
    assert float(off) <= k3._tol(m, n)


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
