"""Rows a process already holds: ``parallel.rows_from_local`` and the
models' mesh entries that take its row shards as they are.

On a 4-shard CPU mesh in one process, and in two gloo processes of 2 CPU
shards each (the child's code is this file's ``__main__``, with a
timeout a process), ``fit``, ``fit_transform`` and ``transform`` from
local rows give the bits of the whole-matrix mesh fit; ``RandomizedPca``
agrees with the plain reference (``port_bench/reference/
randomized_pca.py``); uneven trailing shards are masked; a width, dtype
or layout that differs raises on every process; a ``Rows`` of another
mesh raises.  The ``cuda`` test holds the moments pass to no temporary
the size of its shard.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest
import torch

import petal_decomposition_tpu_torch as pt
from petal_decomposition_tpu_torch.errors import InvalidInput
from petal_decomposition_tpu_torch.parallel import make_mesh, rows_from_local

N, D, K = 1003, 24, 4
SEED = 2 ** 40 + 12345
TIMEOUT_S = 120
MODELS = {
    "RandomizedPca": lambda mesh: pt.RandomizedPca(K, seed=SEED, mesh=mesh),
    "Pca": lambda mesh: pt.Pca(K, mesh=mesh),
    "FastIca": lambda mesh: pt.FastIca(seed=SEED, n_components=K,
                                       max_iter=60, mesh=mesh),
}


def _data(n=N, d=D, dtype=torch.float64, seed=0):
    """Low rank (σⱼ = 3·0.7ʲ) plus noise, with a mean: gaps wide enough
    that float32 components are sound to 1e-5."""
    g = torch.Generator().manual_seed(seed)
    r = min(6, d)
    basis = torch.linalg.qr(torch.randn(d, r, generator=g,
                                        dtype=torch.float64)).Q.mT
    scale = 3.0 * 0.7 ** torch.arange(r, dtype=torch.float64)
    x = (torch.randn(n, r, generator=g, dtype=torch.float64) * scale) @ basis
    x += 0.01 * torch.randn(n, d, generator=g, dtype=torch.float64)
    x += 0.1 * torch.randn(d, generator=g, dtype=torch.float64)
    return x.to(dtype)


def _outputs(model, x):
    """What a mesh model gives on ``x``: its fit_transform, its fitted
    state and its transform of ``x``."""
    y = model.fit_transform(x)
    return [y, model.components_, model.mean_, model.transform(x)]


def _reference_gaps(model, x, dtype) -> dict:
    """The model's first fit against the plain reference in float64, on
    the same test matrix (the models' seed contract)."""
    from port_bench.reference import common as refc
    from port_bench.reference import randomized_pca as ref

    d = x.shape[1]
    l = min(K + 10, x.shape[0], d)
    omega = refc.fit_draws(SEED, [0], (d, l), dtype)[0]
    sol = ref.solve(lambda: iter([x.double()]), {0: omega}, K, 7, "u_pivot",
                    "float64")[0]
    return {
        "sigma": float(((model.singular_values_.double() - sol.sigma).abs()
                        / sol.sigma[0]).max()),
        "components": float((model.components_.double()
                             - sol.components).abs().max()),
        "mean": float((model.mean_.double() - sol.mean).abs().max()
                      / sol.mean.abs().max()),
        "evr": float((model.explained_variance_ratio_.double() - sol.evr)
                     .abs().max() / sol.evr[0]),
    }


MESH4 = None


def _mesh4():
    global MESH4
    if MESH4 is None:
        MESH4 = make_mesh(4, devices=["cpu"] * 4)
    return MESH4


@pytest.mark.parametrize("name", sorted(MODELS))
def test_local_rows_give_the_whole_matrix_fits_bits(name):
    mesh = _mesh4()
    x = _data()
    whole = _outputs(MODELS[name](mesh), x)
    local = MODELS[name](mesh)
    rows = rows_from_local(x, mesh)
    got = _outputs(local, rows)
    assert all(torch.equal(a, b) for a, b in zip(whole, got))
    assert tuple(got[0].shape) == (N, K)
    stats = local.last_fit_stats_
    assert stats.n_samples == N and stats.n_features == D
    assert set(stats.extra) >= {"collective_calls", "collective_bytes"}


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-5)])
def test_randomized_pca_from_local_rows_agrees_with_the_reference(dtype, tol):
    x = _data(dtype=dtype)
    model = pt.RandomizedPca(K, seed=SEED, mesh=_mesh4())
    model.fit(rows_from_local(x, _mesh4()))
    gaps = _reference_gaps(model, x, dtype)
    assert max(gaps.values()) < tol, gaps


@pytest.mark.parametrize("n,valid", [(N, [251, 251, 251, 250]),
                                     (13, [4, 4, 4, 1]),
                                     (9, [3, 3, 3, 0])])
def test_uneven_trailing_shards_are_masked(n, valid):
    x = _data(n=n, d=4)
    rows = rows_from_local(x, _mesh4())
    assert rows.valid == valid and rows.n_valid == n
    assert rows.rows_per_shard == -(-n // 4)
    assert torch.equal(rows.full()[:n], x)
    assert not rows.full()[n:].any()
    one = pt.RandomizedPca(2, seed=SEED, device="cpu").fit(x)
    sharded = pt.RandomizedPca(2, seed=SEED, mesh=_mesh4()).fit(rows)
    for a, b in ((one.singular_values_, sharded.singular_values_),
                 (one.mean_, sharded.mean_),
                 (one.explained_variance_ratio_,
                  sharded.explained_variance_ratio_)):
        assert torch.allclose(a, b, rtol=1e-10, atol=0)


def test_rows_of_another_mesh_raise():
    x = _data()
    rows = rows_from_local(x, _mesh4())
    other = make_mesh(2, devices=["cpu"] * 2)
    for name in sorted(MODELS):
        with pytest.raises(ValueError, match="model's mesh"):
            MODELS[name](other).fit(rows)
    with pytest.raises(ValueError, match="model's mesh"):
        pt.RandomizedPca(K, seed=SEED, device="cpu").fit(rows)
    fitted = pt.RandomizedPca(K, seed=SEED, mesh=other).fit(x)
    with pytest.raises(ValueError, match="model's mesh"):
        fitted.transform(rows)
    # An equal mesh built again is the same mesh.
    again = make_mesh(4, devices=["cpu"] * 4)
    assert again == _mesh4() and hash(again) == hash(_mesh4())
    pt.RandomizedPca(K, seed=SEED, mesh=again).fit(rows)


def test_local_rows_refuse_what_is_not_a_matrix():
    with pytest.raises(InvalidInput, match="2-D"):
        rows_from_local(torch.zeros(8), _mesh4())
    with pytest.raises(InvalidInput, match="no process"):
        rows_from_local(torch.zeros((0, 3)), _mesh4())


# -- two processes ------------------------------------------------------


def _child(port: int, pid: int, out_path: str) -> int:
    import torch.distributed as dist

    from petal_decomposition_tpu_torch.parallel import multihost

    torch.set_num_threads(2)
    multihost.initialize(f"localhost:{port}", 2, pid, backend="gloo")
    mesh = make_mesh(devices=["cpu"] * 2)
    out: dict = {}
    x = _data()
    share = 2 * -(-N // 4)
    mine = x[:share] if pid == 0 else x[share:]
    rows = rows_from_local(mine, mesh)
    out["valid"] = rows.valid
    for name in sorted(MODELS):
        whole = _outputs(MODELS[name](mesh), x)
        got = _outputs(MODELS[name](mesh), rows)
        out[f"bitwise_{name}"] = all(torch.equal(a, b) for a, b in zip(whole, got))
    for dtype in (torch.float64, torch.float32):
        xd = x.to(dtype)
        m = pt.RandomizedPca(K, seed=SEED, mesh=mesh).fit(
            rows_from_local(xd[:share] if pid == 0 else xd[share:], mesh))
        out[f"reference_{dtype}"] = _reference_gaps(m, xd, dtype)
        out["collective_calls"] = m.last_fit_stats_.extra["collective_calls"]

    def refused(local, word):
        try:
            rows_from_local(local, mesh)
        except InvalidInput as err:
            return word in str(err)
        return False

    out["width_refused"] = refused(mine if pid == 0 else mine[:, 1:],
                                   "widths")
    out["dtype_refused"] = refused(mine if pid == 0 else mine.float(),
                                   "dtypes")
    out["layout_refused"] = refused(x[:400] if pid == 0 else x[400:],
                                    "trailing")
    with open(f"{out_path}.{pid}", "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def test_two_processes_fit_the_rows_they_hold(tmp_path):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out_path = str(tmp_path / "rows.json")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(pid),
         out_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    logs, codes = [], []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT_S)
            logs.append(log)
            codes.append(p.returncode)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not any(codes), "\n----\n".join(logs)
    share = -(-N // 4)
    for pid in (0, 1):
        with open(f"{out_path}.{pid}") as f:
            res = json.load(f)
        assert res["valid"] == ([share, share] if pid == 0
                                else [share, N - 3 * share])
        for name in sorted(MODELS):
            assert res[f"bitwise_{name}"] is True, name
        assert max(res["reference_torch.float64"].values()) < 1e-10
        assert max(res["reference_torch.float32"].values()) < 1e-5
        assert res["collective_calls"] > 0
        assert res["width_refused"] and res["dtype_refused"]
        assert res["layout_refused"]


# -- the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_moments_pass_holds_no_temporary_the_size_of_its_shard(cuda_device):
    """``_gram_moments`` on an 8 GiB float32 shard (2²¹ × 1024) raises the
    card's peak allocation by less than 5% of the shard: its ‖X‖² is a
    fused reduction, not ``(X * X).sum()``.  What it does allocate is of
    a fixed size: the d × d Gram, and the staging buffer of PyTorch's
    column sum, which grows with the shard only up to 256 MiB (132 MiB
    at 1 GiB, 256 MiB from 4 GiB on an H100)."""
    from petal_decomposition_tpu_torch.parallel import distributed as pdist
    from petal_decomposition_tpu_torch.parallel.mesh import Rows

    n, d = 1 << 21, 1024
    x = torch.randn(n, d, device=cuda_device) + 0.1
    shard = n * d * 4
    xs = Rows.single(x)
    pdist._gram_moments(xs, True, True, "default", n)  # warm the handles
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    means, gram, tv = pdist._gram_moments(xs, True, True, "default", n)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - before
    assert rise < 0.05 * shard, (rise, shard)
    chunks = x.split(1 << 16)
    mean = sum(c.double().sum(0) for c in chunks) / n
    want = float(sum(((c.double() - mean) ** 2).sum() for c in chunks))
    assert abs(float(tv) - want) / want < 1e-5


if __name__ == "__main__":
    sys.exit(_child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
