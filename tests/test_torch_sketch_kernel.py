"""K1, the fused sketch+moments pass: the port's plain version against
the JAX Pallas kernel run in interpret mode, the wrapper's checks, and
(on a CUDA card) the hand-written kernel against its plain version."""

import numpy as np
import pytest
import torch

from petal_decomposition_tpu.ops.pallas import sketch_kernel as jax_k1
from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1


def _inputs(n, d, l, seed=7):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) + 0.3).astype(np.float32)
    w = rng.standard_normal((d, l)).astype(np.float32)
    return x, w


def _check_against_f64(x, y, cs, sq, y_ref):
    """The bands of tests/test_sketch_kernel.py."""
    scale = float(np.max(np.abs(y_ref)))
    assert float(np.max(np.abs(y - y_ref))) < 1e-4 * scale
    cs_ref = x.sum(axis=0, dtype=np.float64)
    np.testing.assert_allclose(cs, cs_ref, rtol=1e-4, atol=1e-3)
    sq_ref = (x.astype(np.float64) ** 2).sum()
    assert abs(float(sq) - sq_ref) / sq_ref < 1e-5


@pytest.mark.parametrize(
    "n,d,l",
    [
        (4096, 96, 11),   # aligned rows
        (4500, 96, 11),   # ragged last TPU block
        (4100, 128, 42),  # flagship panel width
    ],
)
def test_plain_matches_jax_kernel(n, d, l):
    import jax.numpy as jnp

    x, w = _inputs(n, d, l)
    y_j, cs_j, sq_j = jax_k1._call_kernel(
        jnp.asarray(x), jnp.asarray(w), interpret=True
    )
    y, cs, sq = k1.fused_sketch_moments(torch.from_numpy(x),
                                        torch.from_numpy(w))
    assert y.shape == (n, l) and cs.shape == (d,) and sq.shape == ()
    y, cs, sq = y.numpy(), cs.numpy(), float(sq)
    y_j = np.asarray(y_j)
    # The JAX kernel's bf16×3 product against the port's float32 one.
    scale = float(np.max(np.abs(y_j)))
    assert float(np.max(np.abs(y - y_j))) < 1e-4 * scale
    np.testing.assert_allclose(cs, np.asarray(cs_j), rtol=1e-4, atol=1e-3)
    assert abs(sq - float(sq_j)) / float(sq_j) < 1e-5
    _check_against_f64(x, y, cs, sq, x.astype(np.float64) @ w)


def test_supports_gates():
    f = k1.supports
    assert f(1_000_000, 1024, 42, torch.float32)
    assert f(100_000, 1024, 512, torch.float32)
    assert not f(100_000, 1024, 42, torch.float64)  # float32 only
    assert not f(100_000, 1024, 600, torch.float32)  # panel too wide
    assert not f(100_000, 1024, 0, torch.float32)
    assert not f(512, 1024, 42, torch.float32)  # too small to pay off
    # Same gate as the JAX package at the shapes its tests use.
    for n, d, l in [(4096, 96, 11), (4100, 128, 42), (512, 1024, 42)]:
        assert f(n, d, l, torch.float32) == jax_k1.supports(
            n, d, l, np.float32
        )


@pytest.mark.parametrize(
    "x_shape,w_shape,dtype,err",
    [
        ((4096, 8), (9, 3), torch.float32, ValueError),   # do not chain
        ((4096, 8), (8, 3), torch.float64, TypeError),    # not float32
        ((100, 8), (8, 3), torch.float32, ValueError),    # below supports
        ((4096, 8), (8, 600), torch.float32, ValueError),  # too wide
    ],
)
def test_wrapper_rejects(x_shape, w_shape, dtype, err):
    with pytest.raises(err):
        k1.fused_sketch_moments(torch.zeros(x_shape, dtype=dtype),
                                torch.zeros(w_shape, dtype=dtype))


def test_other_devices_never_take_the_plain_version():
    """Only a CPU tensor runs the plain version; any other device either
    launches the kernel (CUDA) or raises."""
    with pytest.raises(ValueError, match="unsupported device"):
        k1.fused_sketch_moments(torch.empty((4096, 8), device="meta"),
                                torch.empty((8, 3), device="meta"))


def test_cpu_path_never_launches():
    before = k1.launches
    x, w = _inputs(4096, 16, 5)
    k1.fused_sketch_moments(torch.from_numpy(x), torch.from_numpy(w))
    assert k1.launches == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_build_failure_raises_on_card(cuda_device, monkeypatch):
    """A kernel that cannot be built raises; it never falls back."""
    from petal_decomposition_tpu_torch.ops.kernels import _build

    def broken(*args, **kwargs):
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(_build, "load_library", broken)
    x, w = _inputs(4096, 8, 3)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        k1.fused_sketch_moments(torch.from_numpy(x).to(cuda_device),
                                torch.from_numpy(w).to(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,l", [(4500, 96, 11), (6000, 33, 100), (100_000, 1024, 42)]
)
def test_kernel_matches_plain_on_card(cuda_device, n, d, l):
    x, w = _inputs(n, d, l)
    xt = torch.from_numpy(x).to(cuda_device)
    wt = torch.from_numpy(w).to(cuda_device)
    before = k1.launches
    y, cs, sq = k1.fused_sketch_moments(xt, wt)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    y_p, _, _ = k1._sketch_moments_plain(xt, wt)
    _check_against_f64(x, y.cpu().numpy(), cs.cpu().numpy(), float(sq),
                       y_p.cpu().numpy())
