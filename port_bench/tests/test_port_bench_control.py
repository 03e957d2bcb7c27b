"""The control (the reference one precision below the configuration's, in
the program's place) fails each cell's limits, and the program passes
them, at a size the CPU runs; and each fault a cell can have, planted in
the program under a whole run, comes out as not correct."""

import importlib
import time

import pytest
import torch

from port_bench import control
from port_bench.core import harness

from .conftest import ROOT, SEED, tiny_cell

CELLS = ["rpca_1Mx4096_f32.incore", "rpca_1Mx4096_f32.stream",
         "fastica_64x100k_f32.fit"]
CPU = torch.device("cpu")


def family_of(cell):
    return importlib.import_module(f"port_bench.families.{cell.config['family']}")


def failed(checks):
    return [n for n, c in checks.items() if c["value"] > c["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_the_limits_and_the_program_passes(name):
    cell = tiny_cell(name)
    fam = family_of(cell)
    lower = control.LOWER[cell.config["data"]["dtype"]]
    ctl = control.readings(cell, fam, SEED, CPU, "control", 2, lower)
    prog = control.readings(cell, fam, SEED, CPU, "program", 2, lower)
    assert failed(ctl["checks"]), ctl
    assert not failed(prog["checks"]), prog


def run(cell):
    return harness.run_cell(ROOT, cell, SEED, 0.2, False, CPU,
                            time.perf_counter())


def half_the_rows(cls, name):
    real = getattr(cls, name)

    def fit(self, x, *a, **kw):
        if isinstance(x, list):
            return real(self, x[: len(x) // 2], *a, **kw)
        return real(self, x[: x.shape[0] // 2], *a, **kw)
    return fit


def previous_state(cls, name):
    """The entry as a cache keyed on its argument would make it: an
    argument seen before returns at once, leaving the state as it is."""
    real = getattr(cls, name)
    seen = set()

    def fit(self, x, *a, **kw):
        key = id(x) if not isinstance(x, list) else tuple(map(id, x))
        if key in seen:
            return self
        seen.add(key)
        return real(self, x, *a, **kw)
    return fit


def test_a_correct_run_first():
    for name in CELLS:
        assert run(tiny_cell(name))["correct"] is True


@pytest.mark.parametrize("name", CELLS[:2])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "previous_state"])
def test_randomized_pca_faults_are_not_correct(name, fault, monkeypatch):
    from petal_decomposition_tpu_torch import RandomizedPca
    from petal_decomposition_tpu_torch.models import streaming

    cell = tiny_cell(name)
    fam = family_of(cell)
    entry = cell.traffic["entry"]
    if fault == "state_unchanged":
        # Every power step hands its subspace back as it got it.
        real = fam.build_model

        def build(cfg, seed, device):
            m = real(cfg, seed, device)
            m._n_power_iters = 0
            return m
        monkeypatch.setattr(fam, "build_model", build)
    elif fault == "half_the_batch":
        monkeypatch.setattr(RandomizedPca, entry, half_the_rows(RandomizedPca, entry))
    elif fault == "previous_state":
        monkeypatch.setattr(RandomizedPca, entry,
                            previous_state(RandomizedPca, entry))
    else:
        if entry == "fit":
            real = RandomizedPca._install

            def install(self, st, n, d):
                st["sigma"] = st["sigma"].clone()
                st["sigma"][0] *= 1 + 1e-4
                return real(self, st, n, d)
            monkeypatch.setattr(RandomizedPca, "_install", install)
        else:
            real = streaming._install_state

            def install_state(model, m, sigma, vt, k):
                sigma = sigma.clone()
                sigma[0] *= 1 + 1e-4
                return real(model, m, sigma, vt, k)
            monkeypatch.setattr(streaming, "_install_state", install_state)
    r = run(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("fault", ["state_unchanged", "half_the_batch",
                                   "answer_altered", "previous_state"])
def test_fast_ica_faults_are_not_correct(fault, monkeypatch):
    from petal_decomposition_tpu_torch import FastIca
    from petal_decomposition_tpu_torch.models import fast_ica

    if fault == "state_unchanged":
        def step(w, xs, **kw):
            return w, torch.full((), float("inf"), dtype=w.dtype)
        monkeypatch.setattr(fast_ica, "_step", step)
    elif fault == "half_the_batch":
        monkeypatch.setattr(FastIca, "fit", half_the_rows(FastIca, "fit"))
    elif fault == "previous_state":
        monkeypatch.setattr(FastIca, "fit", previous_state(FastIca, "fit"))
    else:
        real = FastIca._inner_fit

        def inner(self, x):
            out = real(self, x)
            self._components = self._components.clone()
            self._components[0, 0] += 1e-3 * self._components.abs().max()
            return out
        monkeypatch.setattr(FastIca, "_inner_fit", inner)
    r = run(tiny_cell(CELLS[2]))
    assert r["correct"] is False, r["checks"]
