"""The port's hi/lo-split float32 products (``ops/splitmm.py``, the
FastICA ds64 stage) against float64 and against the JAX package's: the
cases of tests/test_splitmm.py on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import petal_decomposition_tpu  # noqa: F401  (enables x64 at import)
from petal_decomposition_tpu.ops import splitmm as jax_splitmm
from petal_decomposition_tpu_torch.ops import splitmm


def _normwise(approx, ref):
    approx = np.asarray(approx, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.max(np.abs(approx - ref)) / np.max(np.abs(ref))


def test_split_f64_reconstructs():
    x = np.random.default_rng(0).standard_normal((64, 257)) * 1e3
    hi, lo = splitmm.split_f64(torch.from_numpy(x))
    assert hi.dtype == torch.float32 and lo.dtype == torch.float32
    np.testing.assert_allclose(hi.double().numpy() + lo.double().numpy(), x,
                               rtol=2**-46, atol=0)
    hj, lj = jax_splitmm.split_f64(jnp.asarray(x))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lj))


def test_mm_split_f32_short_contraction():
    """k-length contraction (the FastICA W·X product's shape)."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((64, 64))
    x = rng.standard_normal((64, 4096))
    xh, xl = splitmm.split_f64(torch.from_numpy(x))
    out = splitmm.mm_split_f32(torch.from_numpy(w), xh, xl)
    assert out.dtype == torch.float32
    assert _normwise(out, w @ x) < 1e-6
    xhj, xlj = jax_splitmm.split_f64(jnp.asarray(x))
    out_j = jax_splitmm.mm_split_f32(jnp.asarray(w), xhj, xlj)
    assert _normwise(out, out_j) < 1e-6


@pytest.mark.parametrize("n", [4096, 4096 + 123])
def test_mm_split_chunked_f64_long_contraction(n):
    """n-length contraction (the FastICA G·Xᵀ product's shape), with a
    tail past the last whole chunk in the second case."""
    rng = np.random.default_rng(2)
    g = rng.standard_normal((64, n)).astype(np.float32)
    x = rng.standard_normal((64, n))
    xh, xl = splitmm.split_f64(torch.from_numpy(x))
    out = splitmm.mm_split_chunked_f64(torch.from_numpy(g), xh, xl, chunk=512)
    assert out.dtype == torch.float64
    ref = g.astype(np.float64) @ x.T
    assert _normwise(out, ref) < 1e-6
    xhj, xlj = jax_splitmm.split_f64(jnp.asarray(x))
    out_j = jax_splitmm.mm_split_chunked_f64(jnp.asarray(g), xhj, xlj,
                                             chunk=512)
    assert _normwise(out, out_j) < 1e-6


def test_mm_split_chunked_f64_rejects_f64_left_operand():
    rng = np.random.default_rng(4)
    g64 = torch.from_numpy(rng.standard_normal((8, 600)))
    xh, xl = splitmm.split_f64(torch.from_numpy(rng.standard_normal((8, 600))))
    with pytest.raises(TypeError, match="float32"):
        splitmm.mm_split_chunked_f64(g64, xh, xl)


def test_mm_split_chunked_f64_small_n_fallback():
    """n < 2·chunk takes the unchunked branch."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((8, 600)).astype(np.float32)
    x = rng.standard_normal((8, 600))
    xh, xl = splitmm.split_f64(torch.from_numpy(x))
    out = splitmm.mm_split_chunked_f64(torch.from_numpy(g), xh, xl, chunk=512)
    assert _normwise(out, g.astype(np.float64) @ x.T) < 1e-6
