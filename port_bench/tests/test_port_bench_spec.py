"""BENCHMARK.json keeps to the contract's characters and keys, every cell
finds its files by name, and a cell added as files alone runs."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from port_bench.core import spec

from .conftest import ROOT

BENCH = spec.load(ROOT)


def test_benchmark_json_keeps_to_the_contract():
    assert spec.validate(BENCH) == []
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert spec.NAME_RE.match(m["name"]) and spec.UNIT_RE.match(m["unit"])
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names


@pytest.mark.parametrize("bad", [
    {"unit": "tokens per second"}, {"name": "has space"}, {"name": "a/b"},
    {"unit": "µs"}, {"better": "more"}, {"bound": 0.3}, {"why": "x"},
])
def test_validate_refuses_what_the_contract_refuses(bad):
    b = json.loads(json.dumps(BENCH))
    b["end_to_end"][0].update(bad)
    assert spec.validate(b)


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_by_name(name):
    c = spec.cell(ROOT, BENCH, name)
    assert c.config["family"] and c.traffic["entry"] and c.limits
    assert c.end_to_end and c.per_layer
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    for m in c.end_to_end:
        assert callable(spec.module(ROOT, "end_to_end", m["name"]).value)
    for m in c.per_layer:
        assert callable(spec.module(ROOT, "metrics", m["name"]).value)
    assert callable(spec.module(ROOT, "placements", c.traffic["inputs"]).make)
    assert callable(spec.module(ROOT, "launchers", c.traffic["launcher"]).launch)
    for part in ("families", "counts", "reference"):
        assert (ROOT / "port_bench" / part / f"{c.config['family']}.py").is_file()


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for c in m.get("workloads", cells):
            assert c in moved.get("workloads", cells)


CHILD = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import port_bench
assert port_bench.__file__.startswith(sys.argv[1]), port_bench.__file__
import torch
from port_bench.core import harness, spec
root = sys.argv[1]
c = spec.cell(root, spec.load(root), "rpca_tiny.incore")
launcher = spec.module(root, "launchers", c.traffic["launcher"])
r = launcher.launch(root, c, None, time.perf_counter())
print(json.dumps(r))
"""


def test_a_cell_added_as_files_alone_is_picked_up(tmp_path):
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads(json.dumps(BENCH))
    pb = tmp_path / "port_bench"
    cfg = json.loads((pb / "configs" / "rpca_1Mx4096_f32.json").read_text())
    cfg["data"].update(n=4096, d=128, gen_rows=1024)
    (pb / "configs" / "rpca_tiny.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "incore_once.json").write_text(json.dumps(
        {"why": "one warm-up", "entry": "fit", "launcher": "cpu_once",
         "inputs": "device_copy", "vary": {"blocks": 4, "factors": [0.25, 4]},
         "warmup_fits": 1, "trace_fits": 1, "check_fits": 4}))
    # A placement and a launcher of its own, as files alone.
    (pb / "placements" / "device_copy.py").write_text(
        (pb / "placements" / "device.py").read_text())
    (pb / "launchers" / "cpu_once.py").write_text(
        "import torch\nfrom port_bench.core import harness\n\n\n"
        "def launch(root, cell, args, t_start):\n"
        "    return harness.run_cell(root, cell, 7, 0.3, False,\n"
        "                            torch.device('cpu'), t_start)\n")
    (pb / "limits" / "rpca_tiny.incore.json").write_text(json.dumps(
        {"sigma": 1e-3, "components": 1e-1, "mean": 1e-3, "evr": 1e-3}))
    (pb / "end_to_end" / "fits_done.py").write_text(
        "def value(run):\n    return len(run.fits)\n")
    b["configs"].append({"name": "rpca_tiny", "source": "a test",
                         "file": "port_bench/configs/rpca_tiny.json",
                         "reduced": ["n"], "why": "a test"})
    b["workloads"].append({"name": "rpca_tiny.incore", "config": "rpca_tiny",
                           "traffic": "incore_once", "chips": 1, "why": "a test"})
    for m in b["end_to_end"]:
        if m["name"] == "fit_ms":
            m["workloads"].append("rpca_tiny.incore")
    b["end_to_end"].append({"name": "fits_done", "unit": "fits",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["rpca_tiny.incore"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    assert spec.validate(b) == []
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", CHILD, str(tmp_path)],
                         capture_output=True, text=True, env=env, timeout=300,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["metrics"]["fits_done"]["value"] == r["attempted"] >= 1
    assert set(r["metrics"]) == {"fit_ms", "setup_s", "fits_done"}
