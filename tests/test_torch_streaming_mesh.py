"""Streamed fits of the PyTorch port on an eight-shard CPU mesh: the JAX
package's mesh stream tests (``tests/test_streaming.py:146, 421, 484,
644, 745, 847``) on the port — the sharded stream gives the
single-device stream's outputs — and the sharded stream held against the
JAX package's eight-device one."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import petal_decomposition_tpu as jpd
from petal_decomposition_tpu.parallel import mesh as jmesh
import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.models.streaming import (
    _check_ica_buffer_budget,
)
from petal_decomposition_tpu_torch.parallel import make_mesh

CPU = "cpu"


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=[CPU] * 8)


def _data(n=5000, d=64, offset=3.0, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed)
    scales = np.linspace(3.0, 1.0, d)  # well separated top components
    return (rng.normal(size=(n, d)) * scales + offset).astype(dtype)


def _ica_data(n=4000, k=3, seed=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 50, n)
    s = np.c_[np.sin(2 * t), np.sign(np.sin(3 * t)), rng.laplace(size=n)]
    a = rng.standard_normal((k, k)) + np.eye(k) * 2
    return (s @ a.T + 1.5).astype(dtype)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_stream_on_mesh_matches_single_device(mesh):
    x = _data(n=2048, d=32)
    single = pt.Pca(4, device=CPU).fit_batched(x, block_rows=512)
    meshed = pt.PcaBuilder(4).mesh(mesh).build().fit_batched(
        x, block_rows=512)
    np.testing.assert_allclose(_np(meshed.singular_values_),
                               _np(single.singular_values_), rtol=1e-12)
    np.testing.assert_allclose(_np(meshed.mean_), _np(single.mean_),
                               atol=1e-12)
    r = pt.RandomizedPcaBuilder(4).seed(3).mesh(mesh).build()
    r.fit_batched(x, block_rows=512)
    r1 = pt.RandomizedPca(4, seed=3, device=CPU).fit_batched(x,
                                                            block_rows=512)
    np.testing.assert_allclose(_np(r.singular_values_),
                               _np(r1.singular_values_), rtol=1e-12)


def test_partial_fit_on_mesh(mesh):
    x = _data(n=2048, d=16)
    m = pt.PcaBuilder(3).mesh(mesh).build()
    m.partial_fit(x[:1024], block_rows=256).partial_fit(x[1024:])
    ref = pt.Pca(3, device=CPU).fit_batched(x, block_rows=256)
    np.testing.assert_allclose(_np(m.singular_values_),
                               _np(ref.singular_values_), rtol=1e-11)


def test_partial_fit_mesh_block_rows_consistent(mesh):
    """The same user block_rows is accepted on every call, though the
    mesh rounds it up."""
    x = _data(n=416, d=8)
    m = pt.PcaBuilder(2).mesh(mesh).build()
    m.partial_fit(x[:200], block_rows=100)  # rounds to 104
    m.partial_fit(x[200:], block_rows=100)  # the same value: passes
    assert m._n_samples == 416
    assert m._stream.block_rows == 104
    with pytest.raises(pt.InvalidInput, match="fixed at 104"):
        m.partial_fit(x[:8], block_rows=200)


def test_stream_fast_ica_budget_scales_with_mesh(monkeypatch):
    """The k × n buffer's budget divides by the mesh size (column
    blocks), and the error names the per-device footprint."""
    monkeypatch.setenv("PETAL_STREAM_ICA_HBM_BYTES", str(64 * 2**30))
    # 64 × 100M float64 = 4 GiB × 8 (buffer and temporaries): over one
    # device's 64 GiB, under it on an 8-device mesh.
    dev = torch.device(CPU)
    with pytest.raises(pt.InvalidInput, match="per device"):
        _check_ica_buffer_budget(64, 100_000_000, torch.float64, dev, 2)
    _check_ica_buffer_budget(64, 100_000_000, torch.float64, dev, 8)


def test_stream_fast_ica_on_mesh_matches_single_device(mesh):
    """Column-blocked whitened buffer with a padded tail == the
    single-device stream at the same seed."""
    x = _ica_data(n=4100, seed=17)  # not a block multiple: the tail pads
    st1 = pt.FastIca(seed=31, device=CPU).fit_batched(x, block_rows=1024)
    stm = pt.FastIca(seed=31, mesh=mesh).fit_batched(x, block_rows=1024)
    assert stm.n_iter_ == st1.n_iter_
    np.testing.assert_allclose(_np(stm.components()), _np(st1.components()),
                               rtol=1e-6, atol=1e-9)
    # whiten=False keeps its single-device contract.
    with pytest.raises(pt.InvalidInput, match="single-device"):
        pt.FastIca(seed=1, whiten=False, mesh=mesh).fit_batched(x)


def test_stream_mesh_ica_tail_pads_to_mesh_multiple(mesh):
    """The buffer pads its tail to the next mesh-size multiple, not a
    whole block: one row past a block boundary costs at most size − 1
    dead columns."""
    n = 2048 + 1
    x = _ica_data(n=n, seed=23)
    st1 = pt.FastIca(seed=29, device=CPU).fit_batched(x, block_rows=1024)
    stm = pt.FastIca(seed=29, mesh=mesh).fit_batched(x, block_rows=1024)
    cols = stm.last_fit_stats_.extra["whitened_buffer_cols"]
    assert n <= cols < n + mesh.size
    assert st1.last_fit_stats_.extra["whitened_buffer_cols"] == n
    assert stm.n_iter_ == st1.n_iter_
    np.testing.assert_allclose(_np(stm.components()), _np(st1.components()),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("method", ["fit_batched", "partial_fit"])
def test_mesh_stream_matches_jax_mesh_stream(mesh, method):
    """The port's sharded stream against the JAX package's eight-device
    one: float64 σ, components and means at 1e-10."""
    import jax

    jax_mesh = jmesh.make_mesh(8)
    x = _data(n=3001, d=24, seed=4)
    m = getattr(pt.Pca(4, mesh=mesh), method)(x, block_rows=500)
    mj = getattr(jpd.Pca(4, mesh=jax_mesh), method)(x, block_rows=500)
    assert len(jax.devices()) >= 8

    def rel(a, b):
        a, b = _np(a).astype(np.float64), np.asarray(b, np.float64)
        return np.abs(a - b).max() / np.abs(b).max()

    assert rel(m.singular_values_, mj.singular_values_) < 1e-10
    assert rel(m.components_, mj.components_) < 1e-10
    assert rel(m.mean_, mj.mean_) < 1e-10
