"""Profiling and per-fit observability — the counterpart of
``petal_decomposition_tpu/utils/profiling.py``.

* :func:`trace` — ``torch.profiler`` around a block, written as a
  Chrome/Perfetto trace.
* ``FitStats`` / :func:`record_fit` — wall clock and counters of the
  most recent fit (``model.last_fit_stats_``).  On CUDA the clock is
  read after ``torch.cuda.synchronize()``, so it covers the device work
  and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["trace", "FitStats", "record_fit"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, plus CUDA when available) and write
    ``trace.json`` under ``log_dir``; waits for the device before the
    profile closes."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass
class FitStats:
    """Metrics from the most recent fit."""

    wall_time_s: float = 0.0
    n_samples: int = 0
    n_features: int = 0
    n_iter: int | None = None
    extra: dict = field(default_factory=dict)


@contextlib.contextmanager
def record_fit(model, n: int, d: int, device):
    """Time a fit on ``device`` and attach ``last_fit_stats_`` to the
    model.

    >>> class M: pass
    >>> m = M()
    >>> with record_fit(m, n=100, d=8, device="cpu") as stats:
    ...     stats.extra["note"] = "work happens here"
    >>> m.last_fit_stats_.n_samples, m.last_fit_stats_.n_features
    (100, 8)
    """
    _sync(device)
    t0 = time.perf_counter()
    stats = FitStats(n_samples=n, n_features=d)
    try:
        yield stats
    finally:
        _sync(device)
        stats.wall_time_s = time.perf_counter() - t0
        model.last_fit_stats_ = stats
