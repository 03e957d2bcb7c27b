"""The configuration ``rpca_1Mx1024_f32`` as the in-core cell would run
it (``rpca_1Mx4096_f32.incore``'s traffic and metrics, this
configuration's file and ``limits/rpca_1Mx1024_f32.incore.json``), cut
to 32,768 rows on the CPU, at its published d 1024 and k 32, with the
card's route pinned (the Gram finder and the zero-pass recovery, which
the CPU's autos do not pick): the program is correct against the plain
reference, the TF32 control and the planted faults are not, and the
in-core cell's readers read nothing without a card's trace.

``BENCHMARK.json`` holds no cell of this configuration yet: its fits
stall on the caching allocator's growth while the harness keeps every
window fit's snapshot on the card (``PERF.md`` §7)."""

import importlib
import json
import time
from types import SimpleNamespace

import pytest
import torch

from port_bench import control
from port_bench.core import harness, spec

from .conftest import ROOT, SEED
from .test_port_bench_control import half_the_rows, previous_state

CONFIG = "rpca_1Mx1024_f32"
LIKE = "rpca_1Mx4096_f32.incore"
READERS = ("fit.mfu_pct", "device.idle_pct", "gram_pass.roofline_pct",
           "moments.roofline_pct")


def cut_cell() -> spec.Cell:
    c = spec.cell(ROOT, spec.load(ROOT), LIKE)
    c.name, c.config_name = f"{CONFIG}.incore", CONFIG
    files = ROOT / spec.BENCH_DIR
    c.config = json.loads((files / "configs" / f"{CONFIG}.json").read_text())
    c.limits = json.loads(
        (files / "limits" / f"{c.name}.json").read_text())
    assert (c.config["data"]["d"], c.config["model"]["n_components"]) == (
        1024, 32)
    c.config["data"].update(n=32768, gen_rows=8192)
    c.config["model"].update(range_finder="gram", gram_projection="gram")
    return c


def run(cell, traced=False):
    return harness.run_cell(ROOT, cell, SEED, 0.2, traced,
                            torch.device("cpu"), time.perf_counter())


def test_the_cut_cell_is_correct_and_its_readers_read_nothing_here(
        tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    cell = cut_cell()
    assert sorted(m["name"] for m in cell.per_layer) == sorted(READERS)
    r = run(cell, traced=True)
    assert r["correct"] is True, r["checks"]
    assert set(r["checks"]) == {"sigma", "components", "evr", "mean", "signs"}
    assert not set(READERS) & set(r["metrics"])


def test_the_control_fails_the_limits_and_the_program_passes():
    cell = cut_cell()
    fam = importlib.import_module("port_bench.families.randomized_pca")
    cpu = torch.device("cpu")
    ctl = control.readings(cell, fam, SEED, cpu, "control", 2, "tf32")
    prog = control.readings(cell, fam, SEED, cpu, "program", 2, "tf32")
    assert [n for n, c in ctl["checks"].items() if c["value"] > c["limit"]]
    assert all(c["value"] <= c["limit"] for c in prog["checks"].values())


@pytest.mark.parametrize("fault", ["previous_state", "half_the_batch"])
def test_the_planted_faults_are_not_correct(fault, monkeypatch):
    from petal_decomposition_tpu_torch import RandomizedPca

    plant = previous_state if fault == "previous_state" else half_the_rows
    monkeypatch.setattr(RandomizedPca, "fit", plant(RandomizedPca, "fit"))
    r = run(cut_cell())
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", READERS)
def test_the_readers_return_none_without_a_trace(name):
    cell = cut_cell()
    run_ = SimpleNamespace(
        torch=torch, root=ROOT, cell=cell, cfg=cell.config,
        traffic=cell.traffic, summary=None, peaks=None, traced_fits=[],
        fits=[harness.Fit(50.0)], inputs=SimpleNamespace(arg=None))
    assert spec.module(ROOT, "metrics", name).value(run_) is None
