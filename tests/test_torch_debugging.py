"""``utils/debugging.py``: ``nan_debugging`` raises where the JAX
package's does, leaves clean fits bitwise as they are, and names a
kernel whose output holds a NaN; ``check_finite`` raises
``InvalidInput`` as the JAX package's does."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.utils import debugging as jax_debugging
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.utils import debugging
from petal_decomposition_tpu_torch.utils.debugging import (
    check_finite,
    check_kernel_outputs,
    nan_debugging,
)

CPU = "cpu"
_MODELS = {
    "Pca": (lambda: pt.Pca(3, device=CPU), lambda: jpd.Pca(3)),
    "Pca_gram": (lambda: pt.Pca(3, solver="gram", device=CPU),
                 lambda: jpd.Pca(3, solver="gram")),
    "RandomizedPca": (lambda: pt.RandomizedPca(3, seed=1, device=CPU),
                      lambda: jpd.RandomizedPca(3, seed=1)),
    "FastIca": (lambda: pt.FastIca(seed=2, device=CPU),
                lambda: jpd.FastIca(seed=2)),
}


def _x(n=200, d=12, dtype=np.float64):
    return np.random.default_rng(0).standard_normal((n, d)).astype(dtype)


def _raises_fpe(fn) -> bool:
    try:
        fn()
    except FloatingPointError:
        return True
    return False


@pytest.mark.parametrize("name", list(_MODELS))
@pytest.mark.parametrize("bad", [np.nan, np.inf], ids=["nan", "inf"])
def test_fit_on_bad_input_raises_as_jax(name, bad):
    """A NaN, or an Inf that centering turns into one, in X: both
    packages raise ``FloatingPointError`` inside their contexts."""
    make, make_jax = _MODELS[name]
    x = _x()
    x[3, 4] = bad
    with nan_debugging():
        port = _raises_fpe(lambda: make().fit(x))
    with jax_debugging.nan_debugging():
        jax_raised = _raises_fpe(lambda: make_jax().fit(x))
    assert port and jax_raised


def test_inf_alone_does_not_raise_as_in_jax():
    """An overflow to Inf is not a NaN: neither package raises, and both
    raise once the Inf makes one."""
    big = np.array([1e308, 1.0])
    with nan_debugging():
        y = torch.from_numpy(big) * 10
    with jax_debugging.nan_debugging():
        y_j = jnp.asarray(big) * 10
    assert np.array_equal(y.numpy(), np.asarray(y_j))
    with nan_debugging():
        assert _raises_fpe(lambda: y - y)
    with jax_debugging.nan_debugging():
        assert _raises_fpe(lambda: (y_j - y_j).block_until_ready())


@pytest.mark.parametrize("name", list(_MODELS))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_clean_fit_inside_the_mode_is_bitwise(name, dtype):
    make, _ = _MODELS[name]
    x = _x(dtype=dtype)
    outside = make()
    y = outside.fit_transform(x)
    with nan_debugging():
        inside = make()
        y_in = inside.fit_transform(x)
        t_in = inside.transform(x)
    assert torch.equal(y_in, y)
    assert torch.equal(t_in, outside.transform(x))
    assert torch.equal(inside.components_, outside.components_)


def test_clean_complex_fit_inside_the_mode_is_bitwise():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((100, 8)) + 1j * rng.standard_normal((100, 8))
    y = pt.RandomizedPca(2, seed=3, device=CPU).fit_transform(x)
    with nan_debugging():
        y_in = pt.RandomizedPca(2, seed=3, device=CPU).fit_transform(x)
    assert torch.equal(y_in, y)


def test_views_and_allocations_are_not_results():
    """A view of a tensor that already holds a NaN, and an allocation's
    uninitialized memory, are not checked; a copy is."""
    t = torch.tensor([[1.0, float("nan")], [2.0, 3.0]])
    with nan_debugging():
        t.mT
        t[:, :1]
        torch.empty_like(t)
        with pytest.raises(FloatingPointError, match="aten.clone"):
            t.clone()


def test_kernel_outputs_checked_only_inside_the_mode():
    nan = torch.tensor([0.0, float("nan")])
    ok = torch.zeros(3, dtype=torch.complex64)
    check_kernel_outputs("some_kernel (K9)", nan)  # outside: nothing
    with nan_debugging():
        check_kernel_outputs("some_kernel (K9)", ok, torch.arange(3))
        with pytest.raises(FloatingPointError, match=r"some_kernel \(K9\)"):
            check_kernel_outputs("some_kernel (K9)", ok, nan)
    assert not debugging._active()


@pytest.mark.parametrize(
    "value", [[1.0, np.nan], [np.inf, 0.0], [[1.0, 2.0], [3.0, -np.inf]]]
)
def test_check_finite_matches_jax(value):
    with pytest.raises(pt.InvalidInput) as e:
        check_finite(np.asarray(value), "x")
    with pytest.raises(jpd.InvalidInput) as e_j:
        jax_debugging.check_finite(np.asarray(value), "x")
    assert str(e.value) == str(e_j.value)
    check_finite(torch.ones(3), "x")
    check_finite([1, 2, 3])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nan_panel(m, n, dtype, device):
    """An m×n panel holding one NaN, as the transpose view of a
    contiguous n×m tensor, so the wrappers hand it to their kernel with
    no copy the mode would see first."""
    g = torch.Generator(device=device)
    g.manual_seed(5)
    t = torch.randn(n, m, generator=g, dtype=dtype, device=device)
    t[1, 7] = float("nan")
    return t.mT


@pytest.mark.cuda
def test_nan_out_of_each_kernel_names_it(cuda_device):
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel as k3,
        jacobi_kernels as k2,
        sketch_kernel as k1,
    )

    x = torch.ones(8192, 64, device=cuda_device)
    x[7, 1] = float("nan")
    w = torch.ones(64, 16, device=cuda_device)
    # The inputs are made outside the mode, which would raise at the
    # operation that plants the NaN.
    p32 = _nan_panel(256, 40, torch.float32, cuda_device)
    p64 = _nan_panel(1000, 64, torch.float64, cuda_device)
    cases = [
        (lambda: k1.fused_sketch_moments(x, w),
         r"fused_sketch_moments \(K1\)"),
        (lambda: k2.jacobi_svd_vmem(p32), r"jacobi_svd_vmem \(K2\)"),
        (lambda: k3.jacobi_svd_vmem_f64(p64), r"jacobi_svd_vmem_f64 \(K3\)"),
    ]
    for call, name in cases:
        with nan_debugging(), pytest.raises(FloatingPointError, match=name):
            call()
        call()  # outside the mode the NaN propagates without a raise
