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
    # Both sides take the same bf16×3 split (bitwise, see
    # test_split_matches_jax_bitwise), and bf16 × bf16 products are exact
    # in float32, so only the float32 summation order differs: measured
    # ≤ 2.2e-7·max|Y| at these shapes.
    scale = float(np.max(np.abs(y_j)))
    assert float(np.max(np.abs(y - y_j))) < 1e-6 * scale
    np.testing.assert_allclose(cs, np.asarray(cs_j), rtol=1e-4, atol=1e-3)
    assert abs(sq - float(sq_j)) / float(sq_j) < 1e-5
    _check_against_f64(x, y, cs, sq, x.astype(np.float64) @ w)


def _tie_values():
    """float32 values whose bf16 rounding is a tie (low 16 bits 0x8000),
    both parities of the kept bit and both signs, beside values just
    either side of a tie and random normal values."""
    rng = np.random.default_rng(11)
    # Exponents far from both ends, so no remainder is subnormal.
    hi = rng.integers(0x2000, 0x6000, size=256, dtype=np.uint32)
    sign = rng.integers(0, 2, size=256, dtype=np.uint32) << 15
    ties = ((hi | sign) << 16) | 0x8000
    near = np.concatenate([ties - 1, ties + 1])
    rand = rng.standard_normal(512).astype(np.float32).view(np.uint32)
    return np.concatenate([ties, near, rand]).astype(np.uint32).view(
        np.float32)


def test_split_matches_jax_bitwise():
    """The port's hi/lo split is the JAX kernel's, bit for bit, including
    rounding ties (round to nearest even).  Subnormals stay out: XLA:CPU
    flushes them, which changes only the sign of a zero remainder."""
    import jax.numpy as jnp

    v = _tie_values()
    xj = jnp.asarray(v)
    hi_j = xj.astype(jnp.bfloat16)
    lo_j = (xj - hi_j.astype(jnp.float32)).astype(jnp.bfloat16)
    hi, lo = k1._split_bf16(torch.from_numpy(v))
    for got, want in ((hi, hi_j), (lo, lo_j)):
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16))


def test_supports_gates():
    f = k1.supports
    assert f(1_000_000, 1024, 42, torch.float32)
    assert f(100_000, 1024, 512, torch.float32)
    assert not f(100_000, 1024, 42, torch.float64)  # float32 only
    assert not f(100_000, 1024, 600, torch.float32)  # panel too wide
    assert not f(100_000, 1024, 0, torch.float32)
    assert not f(512, 1024, 42, torch.float32)  # too small to pay off
    # The gate is the port's own: any d fits the card's 32-column
    # k-tiles, while the JAX gate sizes its blocks by a 12 MB TPU VMEM
    # budget.  They agree at these shapes ...
    for n, d, l in [(4096, 96, 11), (4100, 128, 42), (512, 1024, 42)]:
        assert f(n, d, l, torch.float32) == jax_k1.supports(
            n, d, l, np.float32
        )
    # ... and differ, deliberately, at large d (ROADMAP.md §3).
    assert jax_k1.supports(2048, 4096, 42, np.float32)
    assert not f(2048, 4096, 42, torch.float32)
    assert not jax_k1.supports(8192, 20000, 42, np.float32)
    assert f(8192, 20000, 42, torch.float32)


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


def _card_inputs(n, d, l, dev, seed=7, offset=0, spare_rows=0, fill=0.0):
    """X (n, d) and W (d, l) made on the card from a seed.  X starts
    ``offset`` floats into its allocation (offset 1: a base aligned to 4
    bytes only), and ``spare_rows`` rows filled with ``fill`` lie in the
    allocation after its end."""
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    buf = torch.full(((n + spare_rows) * d + offset,), fill, device=dev)
    x = buf[offset:offset + n * d].view(n, d)
    x.copy_(torch.randn(n, d, generator=g, device=dev) + 0.3)
    w = torch.randn(d, l, generator=g, device=dev)
    return x, w


def _check_on_card(x, w, y, cs, sq):
    """Y within 1e-4·max|Y| of the plain version (the same split products;
    the tensor cores sum in another order), the moments against float64
    as in tests/test_sketch_kernel.py."""
    y_p, _, _ = k1._sketch_moments_plain(x, w)
    scale = float(y_p.abs().max())
    assert float((y - y_p).abs().max()) < 1e-4 * scale
    cs64 = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    sq64 = torch.zeros((), dtype=torch.float64, device=x.device)
    for i in range(0, x.shape[0], 1 << 16):
        c = x[i:i + (1 << 16)].double()
        cs64 += c.sum(0)
        sq64 += (c * c).sum()
    assert bool(((cs.double() - cs64).abs()
                 <= 1e-4 * cs64.abs() + 1e-3).all())
    assert abs(float(sq) - float(sq64)) / float(sq64) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,d,l",
    [
        (4500, 96, 11),            # ragged last strip (TMA)
        (6000, 33, 100),           # d % 4 != 0: cp.async route
        (5000, 4097, 42),          # d % 4 != 0, wide
        (100_000, 1024, 42),
        (4100, 64, 1),
        (4100, 64, 256),           # two 128-column chunks
        (4100, 64, 512),           # four chunks
        (4100, 200, 150),          # N = 192
        (1_000_000, 1024, 42),     # the flagship panel
    ],
)
def test_kernel_matches_plain_on_card(cuda_device, n, d, l):
    x, w = _card_inputs(n, d, l, cuda_device)
    before = k1.launches
    y, cs, sq = k1.fused_sketch_moments(x, w)
    torch.cuda.synchronize()
    assert k1.launches == before + 1
    assert y.shape == (n, l) and cs.shape == (d,) and sq.shape == ()
    _check_on_card(x, w, y, cs, sq)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,l", [(4500, 96, 11), (100_000, 1024, 42)])
def test_kernel_unaligned_base_on_card(cuda_device, n, d, l):
    """A view of X whose base is only 4-byte aligned takes the cp.async
    route and gives the same answers."""
    x, w = _card_inputs(n, d, l, cuda_device, offset=1)
    assert x.data_ptr() % 16 == 4
    y, cs, sq = k1.fused_sketch_moments(x, w)
    torch.cuda.synchronize()
    _check_on_card(x, w, y, cs, sq)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,l", [(6000, 33, 100), (100_000, 1024, 42)])
def test_kernel_is_deterministic_on_card(cuda_device, n, d, l):
    x, w = _card_inputs(n, d, l, cuda_device)
    first = k1.fused_sketch_moments(x, w)
    second = k1.fused_sketch_moments(x, w)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 33])
def test_kernel_nan_reaches_its_row_and_moments_on_card(cuda_device, d):
    n, l = 4500, 11
    x, w = _card_inputs(n, d, l, cuda_device)
    x[4321, 7] = float("nan")
    y, cs, sq = k1.fused_sketch_moments(x, w)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[4321]).all())
    rows = torch.ones(n, dtype=torch.bool, device=cuda_device)
    rows[4321] = False
    assert bool(torch.isfinite(y[rows]).all())
    assert bool(torch.isnan(cs[7]))
    cols = torch.ones(d, dtype=torch.bool, device=cuda_device)
    cols[7] = False
    assert bool(torch.isfinite(cs[cols]).all())
    assert bool(torch.isnan(sq))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [96, 33])
@pytest.mark.parametrize("fill", [float("nan"), 1e30])
def test_kernel_ignores_memory_past_the_last_row_on_card(cuda_device, d,
                                                         fill):
    """Rows of the last strip past n contribute nothing, whatever lies in
    memory after X's end."""
    n, l = 4500, 11
    x, w = _card_inputs(n, d, l, cuda_device, spare_rows=512, fill=fill)
    y, cs, sq = k1.fused_sketch_moments(x, w)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all() and torch.isfinite(cs).all()
                and torch.isfinite(sq))
    _check_on_card(x, w, y, cs, sq)
