"""The port's SVD dispatch ladder (the JAX package's ``ops/jacobi.py:
344-400``), the float64 PSD eigensolver through K3, and the complex
``svd_flip`` rule.  Every rung runs here on the CPU through the kernel
wrappers' plain versions, so the QR → kernel-on-R → Q·R_rot composition
is tested without a card."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from petal_decomposition_tpu.ops import linalg as jax_linalg
from petal_decomposition_tpu_torch.ops import jacobi, linalg
from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel as k3
from petal_decomposition_tpu_torch.ops.kernels import jacobi_kernels as k2

F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize(
    "m,n,dtype,device,route",
    [
        (1024, 42, F32, "cuda", "k2"),
        (1024, 42, F64, "cuda", "k3"),          # Bᵀ of the f64 randomized fit
        (1000, 64, F64, "cuda", "k3"),          # BASELINE config 1
        (256, 256, F64, "cuda", "k3"),
        (200_000, 256, F64, "cuda", "qr_k3"),   # the smoke run's f64 fit
        (1_000_000, 64, F32, "cuda", "qr_k2"),  # the smoke run's f32 fit
        (1000, 64, F32, "cuda", "k2"),          # within K2's 4 MiB
        (200_000, 256, F32, "cuda", "qr_k2"),   # the smoke run's wide fit
        (20_000, 632, F32, "cuda", "qr_k2"),    # the widest R K2 takes
        (5000, 169, F32, "cuda", "k2"),
        (5000, 300, F32, "cuda", "qr_k2"),      # no m ≥ 3n rule for f32
        (1500, 600, F64, "cuda", "torch"),      # beyond K3's n_pad ≤ 512
        (5000, 633, F32, "cuda", "torch"),      # beyond K2's R factor
        (1000, 400, F64, "cuda", "torch"),      # m < 3n: no QR for K3
        (1000, 1, F64, "cuda", "torch"),
        (16_384, 64, F64, "cpu", "qr_plain"),   # m·n = 2²⁰
        (16_383, 64, F64, "cpu", "plain"),
        (1000, 64, F32, "cpu", "plain"),
    ],
)
def test_route(m, n, dtype, device, route):
    assert jacobi._route(m, n, dtype, device) == route


def _panel(m, n, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((m, n)) @ np.diag(np.linspace(1, 8, n))
    return torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize(
    "route,dtype",
    [("k2", F32), ("k3", F64), ("qr_k2", F32), ("qr_k3", F64),
     ("torch", F64), ("plain", F64), ("qr_plain", F64)],
)
@pytest.mark.parametrize("n", [8, 9])
def test_each_rung_factors_the_panel(route, dtype, n):
    a = _panel(90, n, dtype)
    q, a_rot, v, off, sweeps = jacobi._rotate(route, a, 30)
    if route.startswith("qr_"):
        assert q.shape == (90, n) and a_rot.shape == (n, n)
        a_rot = q @ a_rot
    else:
        assert q is None
    assert a_rot.shape == (90, n) and v.shape == (n, n)
    assert a_rot.dtype == dtype and v.dtype == dtype
    band = 1e-12 if dtype == F64 else 1e-5
    a64, ar64, v64 = a.double(), a_rot.double(), v.double()
    s = ar64.norm(dim=0).sort(descending=True).values
    s_ref = torch.linalg.svdvals(a64)
    assert float((s - s_ref).abs().max() / s_ref[0]) < band
    assert float((ar64 @ v64.mT - a64).abs().max() / a64.abs().max()) < band
    assert float((v64.mT @ v64 - torch.eye(n, dtype=F64)).abs().max()) < band
    assert float(off) <= linalg.convergence_tol(dtype, 90)
    assert (sweeps > 0) == route.endswith("plain")


def test_qr_rungs_are_the_kernel_on_r():
    """``qr_k3`` is K3 on the R factor, returned beside Q."""
    a = _panel(120, 10, F64, seed=3)
    q, r = torch.linalg.qr(a)
    r_rot, v_r, off_r = k3.jacobi_svd_vmem_f64(r)
    q2, r_rot2, v, off, _ = jacobi._rotate("qr_k3", a, 30)
    assert torch.equal(q2, q) and torch.equal(r_rot2, r_rot)
    assert torch.equal(v, v_r) and float(off) == float(off_r)


@pytest.mark.parametrize("shape", [(40, 12), (12, 40), (33, 7)])
def test_jacobi_svd_on_the_cpu(shape):
    a = _panel(*shape, F64, seed=4) if shape[0] >= shape[1] else (
        _panel(shape[1], shape[0], F64, seed=4).mT
    )
    u, s, vt, off, _ = jacobi.jacobi_svd(a)
    k = min(shape)
    assert u.shape == (shape[0], k) and vt.shape == (k, shape[1])
    assert bool((s[:-1] >= s[1:]).all())
    assert float(((u * s) @ vt - a).abs().max()) < 1e-12


@pytest.mark.parametrize("kind", ["full", "rank5", "odd"])
def test_eigh_psd_by_k3_matches_lapack(kind):
    """K3's eigensolver route (run here through its plain version)
    against ``torch.linalg.eigh``: λ ascending, eigenvectors of the
    resolved spectrum sign-aligned."""
    rng = np.random.default_rng(5)
    n, r = {"full": (16, 16), "rank5": (20, 5), "odd": (9, 9)}[kind]
    b = rng.standard_normal((n, r)) * np.linspace(1, 6, r)
    g = torch.from_numpy(b @ b.T)
    w, v, off = linalg._eigh_psd_k3(g)
    w_ref, v_ref = torch.linalg.eigh(g)
    assert float((w - w_ref).abs().max() / w_ref[-1]) < 1e-12
    assert bool((w[1:] >= w[:-1]).all())
    top = slice(n - r, n)
    sign = torch.sign((v[:, top] * v_ref[:, top]).sum(0))
    assert float((v[:, top] - v_ref[:, top] * sign).abs().max()) < 1e-10
    assert float((g @ v - v * w).abs().max() / w_ref[-1]) < 1e-12
    assert float(off) <= linalg.convergence_tol(F64, n)


def test_eigh_psd_stays_lapack_off_the_card():
    g = torch.from_numpy(np.diag([3.0, 1.0, 2.0]))
    w, v, off = linalg.eigh_psd_jit_cert(g)
    assert w.tolist() == [1.0, 2.0, 3.0] and float(off) == 0.0


def test_complex_svd_goes_to_torch_linalg():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.standard_normal((20, 5))
                         + 1j * rng.standard_normal((20, 5)))
    u, s, vt, off = linalg.svd_jit_cert(a)
    assert u.dtype == torch.complex128 and s.dtype == F64
    assert float(off) == 0.0
    assert float(((u * s) @ vt - a).abs().max()) < 1e-12
    u2, s2, _ = linalg.svd(a)
    assert torch.equal(s, s2)


@pytest.mark.parametrize(
    "u",
    [
        # pivot -0.8+0.1j: real part negative → flip
        [[-0.8 + 0.1j, 0.3], [0.5, -0.9j]],
        # pivot -0.9j: real part exactly 0, imaginary negative → flip
        [[0.1, 0.3 + 0.2j], [-0.9j, 0.5]],
        # pivot +0.9j: real part exactly 0, imaginary positive → keep
        [[0.9j, 0.5 - 0.5j], [0.2, -0.5 + 0.5j]],  # second: |.| tie
        # pivot exactly 0: keep
        [[0j, 1.0], [0j, -2.0 + 0j]],
    ],
)
def test_complex_svd_flip_matches_jax(u):
    u = np.asarray(u, np.complex128)
    vt = (np.arange(6.0).reshape(2, 3) - 2.5) * (1 + 0.5j)
    uj, vtj = jax_linalg.svd_flip(jnp.asarray(u), jnp.asarray(vt))
    up, vtp = linalg.svd_flip(torch.from_numpy(u), torch.from_numpy(vt))
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(vtp.numpy(), np.asarray(vtj))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,n,dtype,k2_launches,k3_launches",
    [
        (1000, 64, F64, 0, 1),     # direct K3
        (20_000, 64, F64, 0, 1),   # QR + K3 on R
        (1000, 64, F32, 1, 0),     # direct K2
        (20_000, 64, F32, 1, 0),   # QR + K2 on R
        (1500, 600, F64, 0, 0),    # cuSOLVER
    ],
)
def test_ladder_on_card(cuda_device, m, n, dtype, k2_launches, k3_launches):
    a = _panel(m, n, dtype, seed=7).to(cuda_device)
    b2, b3 = k2.launches, k3.launches
    u, s, vt, off, _ = jacobi.jacobi_svd(a)
    torch.cuda.synchronize()
    assert (k2.launches - b2, k3.launches - b3) == (k2_launches, k3_launches)
    a64 = a.double()
    rec = ((u.double() * s.double()) @ vt.double() - a64).abs().max()
    band = 1e-11 if dtype == F64 else 1e-5
    assert float(rec / a64.abs().max()) < band
    assert float(off) <= linalg.convergence_tol(dtype, m)


@pytest.mark.cuda
def test_eigh_psd_launches_k3_on_card(cuda_device):
    rng = np.random.default_rng(8)
    b = rng.standard_normal((256, 300))
    g = torch.from_numpy(b @ b.T).to(cuda_device)
    before = k3.launches
    w, v, off = linalg.eigh_psd_jit_cert(g)
    torch.cuda.synchronize()
    assert k3.launches == before + 1
    w_ref = torch.linalg.eigvalsh(g)
    assert float((w - w_ref).abs().max() / w_ref[-1]) < 1e-12
    assert float(off) <= linalg.convergence_tol(F64, 256)
