"""The row-sharded cell (``rpca_10Mx4096_f32.mesh4``) on the CPU: its
launcher (``launchers/nccl_ranks.py``) and placement
(``placements/local_rows.py``) under gloo at a tiny size, in a copy of
the benchmark whose configuration is cut to it.

A whole run on four processes is correct, every rank fitting as many
fits; a wrong shard reads as a failed ``shards`` check; a follower killed
in the window ends the run without a result; a program without
``rows_from_local`` ends it before any process starts; outside a group
the placement only regenerates.
"""

import argparse
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch

from port_bench.core import spec

from .conftest import ROOT, SEED

CELL = "rpca_10Mx4096_f32.mesh4"
TINY = {"n": 8192, "d": 128, "gen_rows": 1024}
TIMEOUT_S = 180

CHILD = r"""
import argparse, json, sys, time
t0 = time.perf_counter()
sys.path.insert(0, sys.argv[1])
from port_bench.core import spec
root = sys.argv[1]
c = spec.cell(root, spec.load(root), sys.argv[2])
launcher = spec.module(root, "launchers", c.traffic["launcher"])
args = argparse.Namespace(seed=int(sys.argv[3]), seconds=float(sys.argv[4]),
                          trace=0)
print(json.dumps(launcher.launch(root, c, args, t0)), flush=True)
"""


def _copy(tmp_path, chips=4, patch=None):
    """A copy of the benchmark with the cell cut to ``TINY`` on ``chips``
    processes; ``patch`` is ``(old, new)`` text of the placement."""
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = spec.load(ROOT)
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["chips"] = chips
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    pb = tmp_path / "port_bench"
    path = pb / "configs" / "rpca_10Mx4096_f32.json"
    cfg = json.loads(path.read_text())
    cfg["data"].update(TINY)
    path.write_text(json.dumps(cfg))
    if patch:
        place = pb / "placements" / "local_rows.py"
        text = place.read_text()
        assert patch[0] in text
        place.write_text(text.replace(patch[0], patch[1]))
    return tmp_path


def _start(root, seconds):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.Popen(
        [sys.executable, "-c", CHILD, str(root), CELL, str(SEED),
         str(seconds)], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _run(root, seconds=1.0):
    p = _start(root, seconds)
    try:
        out, err = p.communicate(timeout=TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0, err[-4000:]
    lines = [json.loads(x) for x in out.strip().splitlines()]
    return lines


def test_a_run_on_four_cpu_processes_is_correct(tmp_path):
    lines = _run(_copy(tmp_path))
    r = lines[-1]
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["shards"]["value"] == 0
    assert set(r["checks"]) == {"sigma", "components", "evr", "mean",
                                "signs", "shards"}
    (fits,) = [x["fits_by_rank"] for x in lines if "fits_by_rank" in x]
    assert len(fits) == 4 and len(set(fits)) == 1
    assert fits[0] == r["attempted"] + 2  # the warm-up fits too


def test_the_checksum_catches_a_wrong_shard(tmp_path):
    root = _copy(tmp_path, chips=2, patch=(
        "    held = torch.zeros(",
        "    if rank == 1:\n        local[3, 5] += 1.0\n"
        "    held = torch.zeros("))
    r = _run(root)[-1]
    assert r["correct"] is False
    assert r["checks"]["shards"]["value"] == 1


def test_a_follower_killed_in_the_window_ends_the_run(tmp_path):
    p = _start(_copy(tmp_path, chips=3), 60.0)
    followers, t_kill = None, None
    try:
        for line in p.stdout:
            obj = json.loads(line)
            followers = obj.get("followers", followers)
            if "card_before_window" in obj:
                time.sleep(1.0)
                t_kill = time.monotonic()
                os.kill(followers[0], signal.SIGKILL)
                break
        out, err = p.communicate(timeout=60)
        took = time.monotonic() - t_kill
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    launcher = spec.module(ROOT, "launchers", "nccl_ranks")
    assert p.returncode == launcher.EXIT_RANK_LOST, err[-3000:]
    assert took < 60
    assert '"correct"' not in out
    for pid in followers:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def test_without_local_rows_the_launcher_exits_at_once(monkeypatch):
    from petal_decomposition_tpu_torch import parallel

    launcher = spec.module(ROOT, "launchers", "nccl_ranks")
    monkeypatch.delattr(parallel, "rows_from_local")
    started = []
    monkeypatch.setattr(subprocess, "Popen",
                        lambda *a, **k: started.append(a))
    cell = spec.cell(ROOT, spec.load(ROOT), CELL)
    args = argparse.Namespace(seed=SEED, seconds=51.0, trace=0)
    t0 = time.monotonic()
    with pytest.raises(SystemExit) as exc:
        launcher.launch(ROOT, cell, args, time.perf_counter())
    assert exc.value.code == launcher.EXIT_NO_LOCAL_ROWS
    assert not started and time.monotonic() - t0 < 5


def test_outside_a_group_the_placement_only_regenerates():
    import importlib

    cell = spec.cell(ROOT, spec.load(ROOT), CELL)
    cell.config["data"].update(TINY)
    cfg, cpu = cell.config, torch.device("cpu")
    fam = importlib.import_module(f"port_bench.families.{cfg['family']}")
    inputs = spec.module(ROOT, "placements", "local_rows").make(
        torch, cfg, cell.traffic, fam, SEED, cpu)
    assert inputs.arg is None and inputs.shard_mismatch == 0
    with pytest.raises(RuntimeError, match="process group"):
        inputs.prepare(0)
    base = torch.cat(list(fam.row_blocks(cfg, SEED, cpu)))
    v = inputs.vary
    for c in range(3):
        want = base.clone()
        want[v.lo:v.hi] *= v.factor(c)
        assert torch.equal(torch.cat(list(inputs.row_blocks(c))), want)
