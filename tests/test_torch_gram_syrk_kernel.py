"""K5, the float32-grade Gram on the tensor cores
(``ops/kernels/gram_syrk.py``): its TF32 rounding; its plain version
against a float64 Gram, and its exact symmetry; which matrices
``supports`` takes (from ``MIN_ROWS`` rows and ``MIN_D`` columns);
``ops.gram.gram`` sending only those to it; the Grams a fit counts in
``extra["gram_kernel_calls"]``, with fits routed through the plain
version by monkeypatching ``supports``; and, on a CUDA card, the kernel
against a float64 Gram on ragged shapes, its bits, the mean-dominated
guard's second Gram, its grade against the IEEE matmul's at the row
floor and above it and on the guard's fused centering, the matmul below
the floor, and its launches in a fit."""

import numpy as np
import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops import gram as pgram
from petal_decomposition_tpu_torch.ops.kernels import gram_syrk as k5
from petal_decomposition_tpu_torch.ops.linalg import ieee_f32
from petal_decomposition_tpu_torch.parallel import distributed as dist
from petal_decomposition_tpu_torch.parallel.mesh import make_mesh


def _data(n, d, seed=0, mean=0.3, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g) * torch.logspace(0, -2, d) + mean
    return x.to(device)


def _errors(g, x):
    """``(relative Frobenius error, largest entry error over the largest
    entry)`` of ``g`` against ``x``'s float64 Gram."""
    ref = x.double().mT @ x.double()
    diff = g.double() - ref
    return (float(diff.norm() / ref.norm()),
            float(diff.abs().max() / ref.abs().max()))


def _ieee(x):
    with ieee_f32():
        return x.mT @ x


@pytest.fixture
def k5_on_cpu(monkeypatch):
    """Every real float32 matrix goes to K5, which on the CPU runs its
    plain version."""
    monkeypatch.setattr(k5, "supports", lambda x: (
        x.dtype == torch.float32 and x.dim() == 2))


# -- on the CPU ------------------------------------------------------------


@pytest.mark.parametrize("value, want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),          # a tie: away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-11 - 2.0**-23, 1.0),          # below the tie
    (1.0 + 3 * 2.0**-11, 1.0 + 2.0**-9),       # a tie, odd: away
    (3.0, 3.0),
    (2.0**-130, 2.0**-130),                    # subnormal, kept
    (2.0**-140, 0.0),                          # below tf32's subnormals
    (0.0, 0.0),
])
def test_tf32_rounds_to_nearest_ties_away(value, want):
    got = k5._tf32(torch.tensor([value], dtype=torch.float32))
    assert float(got[0]) == want


@pytest.mark.parametrize("n, d", [(1, 3), (7, 5), (513, 33), (2000, 64),
                                  (1100, 130)])
def test_plain_against_float64(n, d):
    """Chunks of 512 rows summed in float32 after the 3×TF32 products:
    a few float32 roundings (the IEEE matmul reads up to 2.1e-7 here, the
    plain version up to 3.1e-7: a product drops lo·lo, ≈ 2⁻²² of it)."""
    x = _data(n, d, seed=n + d)
    fro, top = _errors(k5._gram_syrk_plain(x), x)
    assert fro < 5e-7 and top < 5e-7, (fro, top)


@pytest.mark.parametrize("n, d", [(7, 5), (1100, 130)])
def test_plain_is_exactly_symmetric(n, d):
    g = k5._gram_syrk_plain(_data(n, d, seed=3))
    assert torch.equal(g, g.mT)


def test_plain_sums_each_chunk_then_adds_it():
    """A chunk as long as the matrix is one tensor-core sum: the same
    products, added once."""
    x = _data(100, 9, seed=4)
    hi = k5._tf32(x)
    lo = k5._tf32_truncated(x - hi)
    with ieee_f32():
        want = (hi.mT @ lo + lo.mT @ hi) + hi.mT @ hi
    assert torch.equal(k5._gram_syrk_plain(x, chunk_rows=128),
                       k5._mirror_upper(want))


class _Matrix:
    """What ``supports`` reads of a tensor: device, dtype, shape,
    strides, base address."""

    def __init__(self, shape, dtype=torch.float32, device="cuda",
                 strides=None, ptr=0):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.is_cuda = device == "cuda"
        self.device = torch.device(device)
        self._strides = strides or (
            (shape[1], 1) if len(shape) == 2 else (1,))
        self._ptr = ptr

    def dim(self):
        return len(self.shape)

    def stride(self, i):
        return self._strides[i]

    def data_ptr(self):
        return self._ptr


_N = k5.MIN_ROWS


@pytest.mark.parametrize("m, sm90, want", [
    (_Matrix((_N, 4096)), True, True),
    (_Matrix((_N, k5.MIN_D)), True, True),
    (_Matrix((1 << 20, 4096)), True, True),
    (_Matrix((_N, 4100), strides=(4104, 1)), True, True),
    (_Matrix((_N, k5.MIN_D - 4)), True, False),
    (_Matrix((_N - 1, 4096)), True, False),
    (_Matrix((1, 4096)), True, False),
    (_Matrix((_N, 4096)), False, False),
    (_Matrix((_N, 4096), dtype=torch.float64), True, False),
    (_Matrix((_N, 4096), dtype=torch.complex64), True, False),
    (_Matrix((_N, 4096), dtype=torch.bfloat16), True, False),
    (_Matrix((_N, 4096), device="cpu"), True, False),
    (_Matrix((_N, 4096), strides=(1, _N)), True, False),
    (_Matrix((_N, 4098), strides=(4098, 1)), True, False),
    (_Matrix((_N, 4096), ptr=8), True, False),
    (_Matrix((0, 4096)), True, False),
    (_Matrix((4096,)), True, False),
])
def test_supports(monkeypatch, m, sm90, want):
    monkeypatch.setattr(k5, "_is_sm90", lambda device: sm90)
    assert k5.supports(m) is want


def test_gram_syrk_checks_its_input():
    with pytest.raises(TypeError):
        k5.gram_syrk(torch.zeros(4, 4, dtype=torch.float64))
    with pytest.raises(ValueError):
        k5.gram_syrk(torch.zeros(4))


@pytest.mark.parametrize("takes", [True, False])
def test_gram_of_sends_only_what_supports_takes(monkeypatch, takes):
    seen = []
    monkeypatch.setattr(k5, "supports", lambda x: seen.append(x) or takes)
    x = _data(600, 20, seed=5)
    before = k5.calls
    g = pgram.gram(x)
    assert seen and seen[0] is x
    assert k5.calls == before + takes
    want = k5._gram_syrk_plain(x) if takes else _ieee(x)
    assert torch.equal(g, want)


def test_gram_of_keeps_float64_on_the_matmul(k5_on_cpu):
    x = _data(300, 10, seed=6).double()
    before = k5.calls
    g = pgram.gram(x)
    assert k5.calls == before and g.dtype == torch.float64


def test_an_in_core_fit_counts_one_gram(k5_on_cpu):
    x = _data(3000, 40, seed=7)
    model = pt.RandomizedPca(4, seed=1, range_finder="gram",
                             gram_projection="gram", device="cpu").fit(x)
    assert model.last_fit_stats_.extra["gram_kernel_calls"] == 1


def test_an_in_core_fit_through_k5_agrees_with_the_matmul(monkeypatch):
    x = _data(3000, 40, seed=8)

    def fit():
        return pt.RandomizedPca(4, seed=1, range_finder="gram",
                                gram_projection="gram", device="cpu").fit(x)

    plain = fit()
    assert plain.last_fit_stats_.extra["gram_kernel_calls"] == 0
    monkeypatch.setattr(k5, "supports", lambda x: x.dtype == torch.float32)
    via_k5 = fit()
    sv_k5, sv = via_k5.singular_values(), plain.singular_values()
    assert float(((sv_k5 - sv).abs() / sv[0]).max()) < 1e-5


@pytest.mark.parametrize("blocks", [1, 3])
def test_a_stream_counts_one_gram_a_chunk(k5_on_cpu, blocks):
    x = _data(256 * blocks, 24, seed=9).numpy()
    model = pt.RandomizedPca(4, seed=1, device="cpu").fit_batched(
        x, block_rows=256)
    extra = model.last_fit_stats_.extra
    assert extra["streamed_blocks"] == blocks
    assert extra["gram_kernel_calls"] == blocks


def test_partial_fit_counts_its_own_chunks(k5_on_cpu):
    x = _data(512, 24, seed=10).numpy()
    model = pt.Pca(4, device="cpu")
    model.partial_fit(x[:256], block_rows=128)
    model.partial_fit(x[256:], block_rows=128)
    assert model.last_fit_stats_.extra["gram_kernel_calls"] == 2


def test_the_mean_dominated_guard_takes_a_second_gram(k5_on_cpu):
    """Fused centering past ``ops.gram.guard_rmax``: the Gram of X, then
    the Gram of an explicitly centered copy."""
    x = _data(2000, 16, seed=11, mean=50.0)
    before = k5.calls
    _, gc, _ = dist._gram_moments(dist.as_rows(x), True, True, "default",
                                  2000)
    assert k5.calls == before + 2
    xc = (x.double() - x.double().mean(0))
    ref = xc.mT @ xc
    assert float((gc.double() - ref).norm() / ref.norm()) < 1e-6


def test_a_mesh_fit_counts_a_gram_a_shard(k5_on_cpu):
    x = _data(4000, 32, seed=12)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    model = pt.RandomizedPca(4, seed=1, range_finder="gram",
                             gram_projection="gram", mesh=mesh).fit(x)
    assert model.last_fit_stats_.extra["gram_kernel_calls"] == 4


def test_fast_ica_takes_no_gram(k5_on_cpu):
    rng = np.random.default_rng(13)
    s = rng.laplace(size=(2000, 3))
    x = s @ rng.standard_normal((3, 3))
    model = pt.FastIca(seed=1, device="cpu").fit(x.astype(np.float32))
    assert model.last_fit_stats_.extra["gram_kernel_calls"] == 0


# -- on a CUDA card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("K5 needs a compute capability 9.0 card")
    return torch.device("cuda")


@pytest.fixture
def any_width(monkeypatch):
    """K5 below its crossover width and its row floor, to reach narrow
    ragged tiles and short matrices."""
    monkeypatch.setattr(k5, "MIN_D", 1)
    monkeypatch.setattr(k5, "MIN_ROWS", 1)


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, ld", [
    (1, 2048, 2048),        # one row
    (100, 2100, 2100),      # below one stage; d % 128 != 0
    (1000, 2052, 2056),     # a strided view; n % 32 != 0
    (70001, 2100, 2100),    # n past a chunk, not a multiple of one
    (4133, 300, 300),       # three tiles a side, the last ragged
    (5, 4, 4),              # one tile, mostly empty
])
def test_k5_against_float64_on_ragged_shapes(cuda_device, any_width, n, d,
                                             ld):
    base = _data(n, ld, seed=n + d, device=cuda_device)
    x = base[:, :d]
    before = k5.launches
    g = k5.gram_syrk(x)
    torch.cuda.synchronize()
    assert k5.launches == before + 1
    fro, top = _errors(g, x)
    # The tensor cores' sum of a 128-row chunk errs by ≈ 1e-6 of it (their
    # accumulator truncates; 0.9-2.6e-6 on the card, where the IEEE matmul
    # reads 0.1-3e-6 at these sizes, below the row floor that keeps such
    # Grams on the matmul).
    assert fro < 4e-6 and top < 4e-6, (fro, top)


@pytest.mark.cuda
def test_k5_is_symmetric_and_repeats_its_bits(cuda_device, any_width):
    x = _data(20000, 2200, seed=14, device=cuda_device)
    g1 = k5.gram_syrk(x)
    g2 = k5.gram_syrk(x)
    torch.cuda.synchronize()
    assert torch.equal(g1, g1.mT)
    assert torch.equal(g1, g2)


@pytest.mark.cuda
def test_k5_agrees_with_its_plain_version(cuda_device, any_width):
    """The same split and chunks; the tensor cores' chunk sums truncate
    where the plain version's IEEE products round (1.3e-6 apart on the
    card)."""
    x = _data(5000, 2048, seed=15, device=cuda_device)
    g = k5.gram_syrk(x)
    plain = k5._gram_syrk_plain(x)
    torch.cuda.synchronize()
    assert float((g - plain).abs().max() / plain.abs().max()) < 4e-6


@pytest.mark.cuda
def test_k5_on_the_mean_dominated_guard_path(cuda_device):
    n = 50000
    x = _data(n, 2048, seed=16, mean=40.0, device=cuda_device)
    before = k5.launches
    _, gc, _ = dist._gram_moments(dist.as_rows(x), True, True, "default", n)
    torch.cuda.synchronize()
    assert k5.launches == before + 2
    xc = x.double() - x.double().mean(0)
    ref = xc.mT @ xc
    # The float32 centered copy's Gram through K5 (1.1e-6 on the card).
    assert float((gc.double() - ref).norm() / ref.norm()) < 4e-6


@pytest.mark.cuda
@pytest.mark.parametrize("centered", [False, True])
def test_k5_is_held_to_the_ieee_matmuls_grade(cuda_device, centered):
    """The main path's data (``chip_smoke.make_data``) at 262,144 ×
    2048: each error reading of K5 at most 1.1 times the IEEE float32
    matmul's against the float64 Gram."""
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke

    x = chip_smoke.make_data(cuda_device, n=1 << 18, d=2048,
                             seed=chip_smoke.SEED + 60)
    if centered:
        x = x - x.mean(0)
    got = _errors(k5.gram_syrk(x), x)
    want = _errors(_ieee(x), x)
    assert got[0] <= 1.1 * want[0] and got[1] <= 1.1 * want[1], (got, want)


def _shifted(n, d, seed, device):
    """Columns of scales 1 → 0.01 shifted by 0.3 (``_data``), made on the
    card."""
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(n, d, generator=g, device=device)
            * torch.logspace(0, -2, d, device=device) + 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [k5.MIN_D, 4096])
@pytest.mark.parametrize("centered", [False, True])
def test_k5_is_held_to_the_matmuls_grade_at_its_row_floor(cuda_device, d,
                                                          centered):
    """At ``MIN_ROWS`` rows, where K5's truncating chunk sums are the
    largest share of its error, on the mean-shifted columns: each reading
    at most 1.1 times the IEEE matmul's."""
    x = _shifted(k5.MIN_ROWS, d, 18, cuda_device)
    if centered:
        x = x - x.mean(0)
    assert k5.supports(x)
    got = _errors(k5.gram_syrk(x), x)
    want = _errors(_ieee(x), x)
    assert got[0] <= 1.1 * want[0] and got[1] <= 1.1 * want[1], (got, want)


@pytest.mark.cuda
def test_below_the_row_floor_the_gram_stays_on_the_matmul(cuda_device):
    x = _shifted(k5.MIN_ROWS - 32, k5.MIN_D, 19, cuda_device)
    assert not k5.supports(x)
    before = k5.launches
    g = pgram.gram(x)
    torch.cuda.synchronize()
    assert k5.launches == before
    assert torch.equal(g, _ieee(x))


@pytest.mark.cuda
@pytest.mark.parametrize("grade", ["default", "high"])
def test_the_guard_ratio_holds_at_the_row_floor(cuda_device, grade):
    """The fused centering ``XᵀX − n·μμᵀ`` just below the guard's
    threshold, at the fewest rows K5 takes: K5's centered Gram at most
    1.1 times as far from float64 as the matmul's."""
    n, d = k5.MIN_ROWS, k5.MIN_D
    r = 0.95 * pgram.guard_rmax(grade)
    g = torch.Generator(device=cuda_device).manual_seed(20)
    x = torch.randn(n, d, generator=g, device=cuda_device)
    x += r**0.5 * torch.randn(d, generator=g, device=cuda_device)
    mu = x.mean(0).double()
    x64 = x.double()
    mu64 = x64.mean(0)
    ref = x64.mT @ x64 - n * torch.outer(mu64, mu64)
    assert float(n * mu64.square().sum() / ref.trace()) < (
        pgram.guard_rmax(grade))

    def err(gram):
        diff = gram.double() - n * torch.outer(mu, mu) - ref
        return (float(diff.norm() / ref.norm()),
                float(diff.abs().max() / ref.abs().max()))

    got, want = err(k5.gram_syrk(x)), err(_ieee(x))
    assert got[0] <= 1.1 * want[0] and got[1] <= 1.1 * want[1], (got, want)


@pytest.mark.cuda
def test_an_in_core_fit_on_the_card_launches_k5_once(cuda_device):
    x = _data(65536, 2048, seed=17, device=cuda_device)
    before = k5.launches
    model = pt.RandomizedPca(32, seed=2, device=cuda_device).fit(x)
    assert k5.launches == before + 1
    assert model.last_fit_stats_.extra["gram_kernel_calls"] == 1
