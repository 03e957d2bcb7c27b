"""Two processes on gloo: the port's multi-process fits, mirroring
``benchmarks/multihost_check.py`` and ``tests/test_multihost.py``.

Two local processes form a ``torch.distributed`` group over a localhost
coordinator, four CPU shards each (one 8-shard mesh spanning both).  Each
runs the in-core fits with the whole matrix, the streamed fits with its
own half of the rows, and ``partial_fit`` in lockstep; process 0 holds
them against one process's fits at the JAX check's bands, and both check
that the replicated state is bitwise equal across the processes.  The
child's code is this file's ``__main__``; each process has a timeout, so
a hang fails fast.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

N, D, K = 4096, 64, 6
SEED = 1_234_567_891_011_121_314
BR = 512  # the same block_rows on both sides: the same provisional shift
TIMEOUT_S = 120


def _data():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((N, D)) @ np.diag(np.linspace(1, 9, D))
            ).astype(np.float32)


def _ica_data(n=4000):
    rng = np.random.default_rng(5)
    s = np.stack([rng.uniform(-1, 1, n), np.sign(rng.standard_normal(n))],
                 axis=1)
    return s @ np.array([[1.0, 0.5], [0.3, 1.0]])


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _child(port: int, pid: int, out_path: str) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(2)
    import petal_decomposition_tpu_torch as pt
    from petal_decomposition_tpu_torch.parallel import make_mesh, multihost
    from petal_decomposition_tpu_torch.parallel.distributed import all_gather

    multihost.initialize(f"localhost:{port}", 2, pid, backend="gloo")
    assert multihost.process_count() == 2
    assert multihost.process_index() == pid
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.size == 8 and mesh.world == 2
    out = {}
    states = []

    def same_everywhere(name, *tensors):
        """Replicated state: bitwise equal on both processes."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors])
        both = all_gather(flat, mesh)
        states.append(name)
        out[f"bitwise_{name}"] = bool(torch.equal(both[0], both[1]))

    x = _data()
    # In core: the whole matrix on every process, each keeps its shards.
    m = pt.RandomizedPcaBuilder(K).seed(SEED).mesh(mesh).build().fit(x)
    one = pt.RandomizedPca(K, seed=SEED, device="cpu").fit(x)
    out["sigma_rel_diff_vs_single_process"] = _rel(m.singular_values_,
                                                   one.singular_values_)
    out["component_alignment_min"] = float(np.min(np.abs(np.sum(
        m.components_.numpy() * one.components_.numpy(), axis=1))))
    same_everywhere("randomized", m.components_, m.singular_values_,
                    m.mean_)
    y = m.fit_transform(x)
    out["fit_transform_shape"] = list(y.shape)
    same_everywhere("fit_transform", y)

    e = pt.PcaBuilder(K).mesh(mesh).build().fit(x.astype(np.float64))
    e1 = pt.Pca(K, device="cpu").fit(x.astype(np.float64))
    out["exact_sigma_rel_diff"] = _rel(e.singular_values_,
                                       e1.singular_values_)
    same_everywhere("exact", e.components_, e.singular_values_)

    xi = _ica_data()
    # Seed 42 converges on this two-source mixture (at SEED the map
    # lands on the rotation variant and stalls at max_iter).
    ica = pt.FastIca(seed=42, mesh=mesh).fit(xi)
    ica1 = pt.FastIca(seed=42, device="cpu", whiten_solver="eigh").fit(xi)
    out["ica_n_iter"] = [ica.n_iter_, ica1.n_iter_]
    out["ica_components_max_diff"] = float(
        (ica.components_ - ica1.components_).abs().max())
    same_everywhere("fast_ica", ica.components_)

    # Streams: each process feeds its own half of the rows.
    x64 = x.astype(np.float64)
    half = N // 2
    x_loc = x64[:half] if pid == 0 else x64[half:]
    st = pt.Pca(K, mesh=mesh).fit_batched(
        [x_loc[:1100], x_loc[1100:]], block_rows=BR)
    st1 = pt.Pca(K, device="cpu").fit_batched(x64, block_rows=BR)
    out["streamed_exact_sigma_rel_diff"] = _rel(st.singular_values_,
                                                st1.singular_values_)
    same_everywhere("streamed_exact", st.components_, st.singular_values_)
    r = pt.RandomizedPca(K, seed=SEED, mesh=mesh).fit_batched(
        x_loc, block_rows=BR)
    r1 = pt.RandomizedPca(K, seed=SEED, device="cpu").fit_batched(
        x64, block_rows=BR)
    out["streamed_randomized_sigma_rel_diff"] = _rel(r.singular_values_,
                                                     r1.singular_values_)
    same_everywhere("streamed_randomized", r.components_,
                    r.singular_values_)
    # partial_fit is collective: both processes call it in lockstep.
    pf = pt.Pca(K, mesh=mesh)
    pf.partial_fit(x_loc[:700], block_rows=BR)
    pf.partial_fit(x_loc[700:], block_rows=BR)
    out["streamed_partial_fit_sigma_rel_diff"] = _rel(pf.singular_values_,
                                                      st1.singular_values_)
    out["partial_fit_calls"] = pf.last_fit_stats_.extra["partial_fit_calls"]
    # Zero new rows still joins the fold (and draws on both processes).
    pf.partial_fit(np.zeros((0, D)))
    out["partial_fit_calls_after_empty"] = (
        pf.last_fit_stats_.extra["partial_fit_calls"])
    same_everywhere("partial_fit", pf.components_, pf.singular_values_)

    # A per-process dtype mismatch raises on every process.
    x_bad = x_loc.astype(np.float32) if pid == 0 else x_loc
    try:
        pt.Pca(K, mesh=mesh).fit_batched(x_bad, block_rows=BR)
        out["dtype_mismatch_rejected"] = False
    except pt.InvalidInput as err:
        out["dtype_mismatch_rejected"] = "dtype" in str(err)
    # So does a process with no rows.
    try:
        pt.Pca(K, mesh=mesh).fit_batched(
            x_loc if pid == 0 else [], block_rows=BR)
        out["empty_stream_rejected"] = False
    except pt.InvalidInput as err:
        out["empty_stream_rejected"] = "every process" in str(err)
    out["states"] = states
    with open(f"{out_path}.{pid}", "w") as f:
        json.dump(out, f)
    # Leave the group together: a process that exits while its peer
    # still holds gloo connections to it can abort in the teardown.
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _run_pair(tmp_path) -> list[dict]:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out_path = str(tmp_path / "mh.json")
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(port), str(pid),
             out_path],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    logs, codes = [], []
    try:
        for p in procs:
            log, _ = p.communicate(timeout=TIMEOUT_S)
            logs.append(log)
            codes.append(p.returncode)
    finally:
        # A failed child must not leave its sibling waiting in a
        # collective.
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert not any(codes), "\n----\n".join(logs)
    results = []
    for pid in (0, 1):
        with open(f"{out_path}.{pid}") as f:
            results.append(json.load(f))
    return results


def test_two_process_gloo(tmp_path):
    for res in _run_pair(tmp_path):
        # The JAX check's bands (benchmarks/multihost_check.py).
        assert res["sigma_rel_diff_vs_single_process"] < 1e-4
        assert res["component_alignment_min"] > 1 - 1e-4
        assert res["streamed_exact_sigma_rel_diff"] < 1e-9
        assert res["streamed_randomized_sigma_rel_diff"] < 1e-9
        assert res["streamed_partial_fit_sigma_rel_diff"] < 1e-9
        assert res["partial_fit_calls"] == 2
        assert res["partial_fit_calls_after_empty"] == 3
        assert res["exact_sigma_rel_diff"] < 1e-10
        assert res["fit_transform_shape"] == [N, K]
        assert res["ica_n_iter"][0] == res["ica_n_iter"][1] < 200
        assert res["ica_components_max_diff"] < 1e-7
        assert res["dtype_mismatch_rejected"] is True
        assert res["empty_stream_rejected"] is True
        # Replicated state is bitwise equal across the two processes.
        for name in res["states"]:
            assert res[f"bitwise_{name}"] is True, name


def test_initialize_explicit_failure_raises():
    """A misconfigured explicit coordinator raises instead of falling
    back to one process (JAX ``tests/test_contracts.py``)."""
    from petal_decomposition_tpu_torch.parallel import multihost

    with pytest.raises(ValueError):
        multihost.initialize("localhost:1", num_processes=2, process_id=5)
    with pytest.raises(ValueError):
        multihost.initialize("localhost:1", num_processes=2)
    assert multihost.process_count() == 1


# (cards seen, torchrun environment or None for an explicit
#  initialize(process_id=RANK), the process's cards)
_LAYOUTS = {
    "one_per_card": (4, {"RANK": 6, "WORLD_SIZE": 8, "LOCAL_RANK": 2,
                         "LOCAL_WORLD_SIZE": 4}, [2]),
    "two_cards_each": (4, {"RANK": 1, "WORLD_SIZE": 2, "LOCAL_RANK": 1,
                           "LOCAL_WORLD_SIZE": 2}, [2, 3]),
    "explicit": (4, {"RANK": 3, "WORLD_SIZE": 4}, [3]),
}


@pytest.mark.parametrize("layout", sorted(_LAYOUTS))
def test_group_process_takes_its_own_cards(monkeypatch, layout):
    """In a group, ``initialize`` makes the process's first card current
    for NCCL and ``make_mesh()`` gives each process its own cards, never
    every card to every rank (NCCL refuses two ranks on one card).  The
    card count, the group and torchrun's environment are faked."""
    import torch
    import torch.distributed as dist

    from petal_decomposition_tpu_torch.parallel import distributed as pdist
    from petal_decomposition_tpu_torch.parallel import mesh as pmesh
    from petal_decomposition_tpu_torch.parallel import multihost

    n_cards, env, want = _LAYOUTS[layout]
    rank, world = env["RANK"], env["WORLD_SIZE"]
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    if layout != "explicit":
        for k, v in env.items():
            monkeypatch.setenv(k, str(v))
        monkeypatch.setenv("MASTER_ADDR", "localhost")
    current, joined = [], []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    if layout == "explicit":
        multihost.initialize("localhost:1", world, rank)
    else:
        multihost.initialize()
    assert joined == ["nccl"]
    assert current == [want[0]]

    monkeypatch.setattr(pmesh, "_group_world", lambda: (None, rank, world))
    monkeypatch.setattr(pdist, "all_gather",
                        lambda t, mesh: t.expand(mesh.world, *t.shape))
    mesh = pmesh.make_mesh()
    assert mesh.devices == tuple(torch.device("cuda", i) for i in want)
    assert mesh.lead == torch.device("cuda", want[0])
    assert mesh.size == len(want) * world


def test_helpers_single_process():
    """Auto mode with no torchrun environment is a no-op (JAX
    ``tests/test_observability.py``)."""
    from petal_decomposition_tpu_torch.parallel import multihost

    env = {k: os.environ.pop(k) for k in ("RANK", "WORLD_SIZE")
           if k in os.environ}
    try:
        multihost.initialize()
    finally:
        os.environ.update(env)
    assert multihost.is_multihost() is False
    assert multihost.process_index() == 0


if __name__ == "__main__":
    sys.exit(_child(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]))
