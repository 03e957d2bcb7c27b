"""One run of one cell: set-up, the measured window, the traced fits, the
readers and the comparison that decides ``correct``.

:func:`run_cell` takes the device it is given and does not look for a
card: :mod:`.cli` does that, and a launcher (``launchers/``) picks the
device, so the tests can drive a whole run on the CPU at a small size.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

from . import device as devinfo
from . import imports, spec, trace
from .inputs import Inputs


@dataclass
class Fit:
    ms: float
    n_iter: int | None = None


@dataclass
class Run:
    """What the readers see."""

    torch: object
    root: Path
    cell: spec.Cell
    family: object
    counts: object
    inputs: Inputs
    device: object
    peaks: dict | None
    setup_s: float = 0.0
    fits: list = field(default_factory=list)
    traced_fits: list = field(default_factory=list)
    summary: trace.Summary | None = None
    peak_bytes: int = 0
    window_s: float = 0.0

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


def log(obj) -> None:
    """An earlier line of the run's standard output."""
    print(json.dumps(obj), flush=True)


def make_inputs(root, torch, cfg, traffic, family, seed: int, device) -> Inputs:
    """The configuration's rows from ``seed``, made on ``device`` by the
    family's generator and placed by ``placements/<traffic inputs>.py``."""
    placement = spec.module(root, "placements", traffic["inputs"])
    return placement.make(torch, cfg, traffic, family, seed, device)


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_fit(torch, device, entry, inputs, c, model) -> Fit:
    """Fit number ``c``: its data made, then timed from the call to its
    return and a synchronize."""
    arg = inputs.prepare(c)
    _sync(torch, device)
    t0 = time.perf_counter()
    entry(arg)
    _sync(torch, device)
    return Fit((time.perf_counter() - t0) * 1e3,
               getattr(model, "n_iter_", None))


def trace_dir(root: Path) -> Path:
    """Where traced runs write their profiler trace: ``$TMPDIR`` where it
    is set, else the checkout's ``build/``."""
    base = os.environ.get("TMPDIR")
    d = (Path(base) if base else Path(root) / "build") / "port_bench_traces"
    d.mkdir(parents=True, exist_ok=True)
    return d


def run_cell(root: Path, cell: spec.Cell, seed: int, seconds: float,
             traced: bool, device, t_start: float) -> dict:
    """One run; returns the result object (the last line's content).
    ``t_start`` is the host clock when the process started its work."""
    import torch

    root = Path(root)
    cfg, traffic = cell.config, cell.traffic
    family = importlib.import_module(f"port_bench.families.{cfg['family']}")
    counts = importlib.import_module(f"port_bench.counts.{cfg['family']}")
    info = devinfo.describe(torch, device, cell.chips)
    run = Run(torch, root, cell, family, counts, None, device,
              devinfo.peaks(root, info["kind"]))

    # -- set-up: inputs from the seed, the model, its shapes warmed ---------
    run.inputs = make_inputs(root, torch, cfg, traffic, family, seed, device)
    model = family.build_model(cfg, seed, device)
    entry = getattr(model, traffic["entry"])
    n_calls = 0
    for _ in range(int(traffic["warmup_fits"])):
        _timed_fit(torch, device, entry, run.inputs, n_calls, model)
        n_calls += 1
    run.setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    log({"card_before_window": devinfo.smi_sample(), "setup_s": run.setup_s})

    # -- the measured window: fits back to back, a closed loop -------------
    snaps, attempted, failed = [], 0, 0
    deadline = time.perf_counter() + seconds
    w0 = time.perf_counter()
    while time.perf_counter() < deadline:
        attempted += 1
        try:
            fit = _timed_fit(torch, device, entry, run.inputs, n_calls, model)
        except Exception:  # a fit that raises is a failed request
            failed += 1
            traceback.print_exc(file=sys.stderr)
            break
        run.fits.append(fit)
        snaps.append((n_calls, family.snapshot(model)))
        n_calls += 1
    run.window_s = time.perf_counter() - w0
    if device.type == "cuda":
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    log({"card_after_window": devinfo.smi_sample()})
    log({"fits": [[f.ms, f.n_iter] for f in run.fits],
         "window_s": run.window_s})
    # What the last fit of the window leaves beyond its snapshot, before
    # any traced fit replaces its state.
    last = family.final(model, run.inputs) if run.fits else {}

    # -- traced fits, after the window --------------------------------------
    if traced and run.fits:
        path = trace_dir(root) / f"{cell.name}-{seed}.json"

        def traced_fits():
            return [_timed_fit(torch, device, entry, run.inputs, n_calls + i,
                               model)
                    for i in range(int(traffic["trace_fits"]))]

        run.summary, run.traced_fits = trace.profile(torch, traced_fits, path)
        log({"trace": str(path), "traced_fits":
             [[f.ms, f.n_iter] for f in run.traced_fits]})

    # -- metrics ------------------------------------------------------------
    wanted = cell.per_layer if traced else cell.end_to_end
    kind = "metrics" if traced else "end_to_end"
    metrics = {}
    if run.fits:
        for m in wanted:
            value = spec.module(root, kind, m["name"]).value(run)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    # -- correct: what the window's fits returned, against the reference ---
    del model, entry
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = (family.judge(cfg, traffic, seed, run.inputs, snaps,
                           last, cell.limits, device)
              if run.fits else [])
    correct = bool(run.fits) and failed == 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)

    info["memory_peak_bytes"] = run.peak_bytes
    if traced and run.summary is not None:
        info["busy_s"] = run.summary.busy_s
        info["window_s"] = run.summary.window_s
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if traced and run.summary is not None:
        result["breakdown"] = {"device_ops": trace.device_ops(run.summary),
                               "idle_gaps": trace.idle_gaps(run.summary)}
    result["checks"] = {name: {"value": v, "limit": lim}
                        for name, v, lim in checks}
    loaded = imports.forbidden_loaded()
    if loaded:
        raise ForbiddenModules(loaded)
    return result


class ForbiddenModules(RuntimeError):
    """JAX or the JAX package was loaded in the process."""
