"""The Grams a fit counts: ``ops.gram.gram`` makes each one with K5 or
with the IEEE matmul, and ``extra["gram_kernel_calls"]`` and
``extra["gram_matmul_calls"]`` count them, so their sum is the Grams the
fit made whichever arithmetic made them: one in core, one a chunk of a
stream, one a shard of a mesh, two where the mean-dominated guard takes
a second, none in FastICA or the direct finder.  On the CPU the Grams go
to the matmul, or (``route="k5"``) to K5's plain version by
monkeypatching ``supports``; on a CUDA card the default
``RandomizedPca(32)`` takes the matmul below K5's ``MIN_D`` and K5 from
it."""

import numpy as np
import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.ops import gram as pgram
from petal_decomposition_tpu_torch.ops.kernels import gram_syrk as k5
from petal_decomposition_tpu_torch.parallel import distributed as dist
from petal_decomposition_tpu_torch.parallel.mesh import make_mesh

ROUTES = ["matmul", "k5"]


def _data(n, d, seed=0, mean=0.3, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(n, d, generator=g, device=device)
            * torch.logspace(0, -2, d, device=device) + mean)


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """``"matmul"``: every Gram on the CPU's IEEE matmul, as
    ``supports`` rules there; ``"k5"``: every real float32 matrix to K5's
    plain version."""
    if request.param == "k5":
        monkeypatch.setattr(k5, "supports", lambda x: (
            x.dtype == torch.float32 and x.dim() == 2))
    return request.param


def _counts(model):
    extra = model.last_fit_stats_.extra
    return extra["gram_kernel_calls"], extra["gram_matmul_calls"]


def _split(route, grams):
    """``(kernel, matmul)`` for ``grams`` Grams on ``route``."""
    return (grams, 0) if route == "k5" else (0, grams)


def test_an_in_core_gram_route_fit_counts_one_gram(route):
    x = _data(3000, 40, seed=1)
    model = pt.RandomizedPca(4, seed=1, range_finder="gram",
                             gram_projection="gram", device="cpu").fit(x)
    assert _counts(model) == _split(route, 1)


@pytest.mark.parametrize("blocks", [1, 3])
def test_a_stream_counts_one_gram_a_chunk(route, blocks):
    x = _data(256 * blocks, 24, seed=2).numpy()
    model = pt.RandomizedPca(4, seed=1, device="cpu").fit_batched(
        x, block_rows=256)
    assert model.last_fit_stats_.extra["streamed_blocks"] == blocks
    assert _counts(model) == _split(route, blocks)


def test_partial_fit_counts_its_own_chunks(route):
    x = _data(512, 24, seed=3).numpy()
    model = pt.Pca(4, device="cpu")
    model.partial_fit(x[:256], block_rows=128)
    model.partial_fit(x[256:], block_rows=128)
    assert _counts(model) == _split(route, 2)


def test_a_mesh_fit_counts_one_gram_a_shard(route):
    x = _data(4000, 32, seed=4)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    model = pt.RandomizedPca(4, seed=1, range_finder="gram",
                             gram_projection="gram", mesh=mesh).fit(x)
    assert _counts(model) == _split(route, 4)


def test_the_mean_dominated_guard_counts_its_second_gram(route):
    """Fused centering past ``ops.gram.guard_rmax``: the Gram of X, then
    the Gram of an explicitly centered copy, each counted once."""
    x = _data(2000, 16, seed=5, mean=50.0)
    kernel, matmul = k5.calls, pgram.matmul_calls
    dist._gram_moments(dist.as_rows(x), True, True, "default", 2000)
    assert (k5.calls - kernel, pgram.matmul_calls - matmul) == _split(
        route, 2)


def test_a_float64_gram_stays_on_the_matmul_and_is_counted(route):
    before = pgram.matmul_calls
    g = pgram.gram(_data(300, 10, seed=6).double())
    assert g.dtype == torch.float64
    assert pgram.matmul_calls == before + 1


def test_a_direct_finder_fit_takes_no_gram(route):
    model = pt.RandomizedPca(4, seed=1, range_finder="direct",
                             device="cpu").fit(_data(3000, 40, seed=7))
    assert _counts(model) == (0, 0)


def test_fast_ica_takes_no_gram(route):
    rng = np.random.default_rng(8)
    x = rng.laplace(size=(2000, 3)) @ rng.standard_normal((3, 3))
    model = pt.FastIca(seed=1, device="cpu").fit(x.astype(np.float32))
    assert _counts(model) == (0, 0)


# -- on a CUDA card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("K5 needs a compute capability 9.0 card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, d, want", [
    (1 << 20, 1024, (0, 1)),    # d < MIN_D: the IEEE matmul
    (1 << 16, 4096, (1, 0)),    # K5
])
def test_the_default_fit_on_the_card_counts_its_gram_where_it_ran(
        cuda_device, n, d, want):
    x = _data(n, d, seed=9, device=cuda_device)
    launches = k5.launches
    model = pt.RandomizedPca(32, seed=2, device=cuda_device).fit(x)
    torch.cuda.synchronize()
    assert _counts(model) == want
    assert k5.launches == launches + want[0]
