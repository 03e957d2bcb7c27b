"""A whole run on the CPU (the harness's look for a card skipped), its
last line's shape, the run without a card, the import check, and the
trace's reduction."""

import importlib
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench.core import cli, harness, imports, trace

from .conftest import ROOT, SEED, tiny_cell

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", ["rpca_1Mx4096_f32.incore",
                                  "rpca_1Mx4096_f32.stream",
                                  "fastica_64x100k_f32.fit"])
def test_a_run_on_the_cpu_is_correct_and_shaped(name):
    cell = tiny_cell(name)
    r = harness.run_cell(ROOT, cell, SEED, 0.3, False, torch.device("cpu"),
                         time.perf_counter())
    assert list(r) == RESULT_KEYS
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["checks"]) == {k for k in cell.limits if not k.startswith("_")}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert r["metrics"]["setup_s"]["value"] > 0
    json.dumps(r)
    assert cli.check_lines(r["checks"])[0].startswith("check ")


@pytest.mark.parametrize("name", ["rpca_1Mx4096_f32.incore",
                                  "rpca_1Mx4096_f32.stream"])
def test_each_fit_sees_its_own_data_exactly(name):
    cell = tiny_cell(name)
    cfg, cpu = cell.config, torch.device("cpu")
    fam = importlib.import_module(f"port_bench.families.{cfg['family']}")
    inputs = harness.make_inputs(ROOT, torch, cfg, cell.traffic, fam, SEED,
                                 cpu)
    base = torch.cat(list(fam.row_blocks(cfg, SEED, cpu)))
    v = inputs.vary
    assert 0 <= v.lo < v.hi <= base.shape[0]

    def want(c):
        x = base.clone()
        x[v.lo:v.hi] *= v.factor(c)
        return x

    for c in range(5):
        arg = inputs.prepare(c)
        got = (arg if isinstance(arg, torch.Tensor)
               else torch.from_numpy(np.concatenate(arg)))
        assert torch.equal(got, want(c))
        assert not torch.equal(got, want(c + 1))
        for other in (c - 1, c, c + 1):
            assert torch.equal(torch.cat(list(inputs.row_blocks(other))),
                               want(other))
    assert inputs.key(0) != inputs.key(1) and inputs.key(0) == inputs.key(2)


def test_without_a_card_the_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "rpca_1Mx4096_f32.incore", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == cli.EXIT_NO_CARD
    assert "metrics" not in out.stdout and "device" not in out.stdout
    assert "CUDA device" in out.stderr


IMPORTS_ALL = r"""
import importlib, json, pathlib, sys
sys.path.insert(0, sys.argv[1])
from port_bench.core import cli, harness, spec, imports
root = pathlib.Path(sys.argv[1])
import port_bench.control
import petal_decomposition_tpu_torch
b = spec.load(root)
for c in b["configs"]:
    fam = spec.cell(root, b, [w["name"] for w in b["workloads"] if w["config"] == c["name"]][0]).config["family"]
    for part in ("families", "counts", "reference"):
        importlib.import_module(f"port_bench.{part}.{fam}")
for m in b["end_to_end"]:
    spec.module(root, "end_to_end", m["name"])
for m in b["per_layer"]:
    spec.module(root, "metrics", m["name"])
for w in b["workloads"]:
    t = spec.cell(root, b, w["name"]).traffic
    spec.module(root, "placements", t["inputs"])
    spec.module(root, "launchers", t["launcher"])
print(json.dumps(sorted(imports.top_level(sys.modules))))
"""

IMPORTS_REFERENCE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import port_bench.reference.common, port_bench.reference.randomized_pca
import port_bench.reference.fast_ica
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _loaded(code):
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    loaded = _loaded(IMPORTS_ALL)
    assert imports.PROGRAM in loaded
    assert imports.forbidden_loaded(loaded) == []


def test_the_reference_loads_nothing_of_the_program_or_jax():
    loaded = _loaded(IMPORTS_REFERENCE)
    assert imports.forbidden_loaded(loaded) == []
    assert imports.PROGRAM not in loaded


def test_the_check_compares_whole_top_level_names():
    assert imports.forbidden_loaded({"petal_decomposition_tpu_torch.models": 1}) == []
    assert imports.forbidden_loaded({"petal_decomposition_tpu.ops": 1}) == [
        "petal_decomposition_tpu"]
    assert imports.forbidden_loaded({"jaxlib.xla": 1, "jaxtyping": 1}) == ["jaxlib"]


def ev(cat, name, start, dur):
    return trace.Event(cat, name, start, dur)


def test_trace_reduction_busy_union_and_idle_by_host_activity():
    events = [
        ev("kernel", "gemm", 0.0, 1.0), ev("kernel", "gemm", 0.5, 1.0),
        ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 2.0, 0.5),
        ev("kernel", "tanh", 4.0, 1.0),
        ev("cpu_op", "fit", 0.0, 5.0),
        ev("cuda_runtime", "cudaStreamSynchronize", 1.6, 0.3),
        ev("cpu_op", "aten::item", 2.6, 1.2),
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(5.0)
    assert s.busy_s == pytest.approx(1.5 + 0.5 + 1.0)
    assert s.busy == [(0.0, 1.5), (2.0, 2.5), (4.0, 5.0)]
    assert trace.device_ops(s)[0] == ["gemm", 2.0]
    gaps = dict(map(tuple, trace.idle_gaps(s)))
    assert gaps == pytest.approx({"cudaStreamSynchronize": 0.5, "aten::item": 1.5})
    assert [e.name for e in s.copies("HtoD")] == [
        "Memcpy HtoD (Pinned -> Device)"]
    assert len(s.kernels()) == 3


def test_trace_reads_a_chrome_trace():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "cpu_op", "name": "op", "ts": 0.0, "dur": 20.0},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 1.0},
        {"ph": "X", "cat": "python_function", "name": "f", "ts": 0, "dur": 1},
    ]}
    evs = trace.events_from_chrome(doc)
    assert [(e.cat, e.name) for e in evs] == [("kernel", "k"), ("cpu_op", "op")]
    assert [(e.start, e.dur) for e in evs] == [
        pytest.approx((1e-5, 5e-6)), pytest.approx((0.0, 2e-5))]
