"""Profiling and per-fit observability — the counterpart of
``petal_decomposition_tpu/utils/profiling.py``.

* :func:`trace` — ``torch.profiler`` around a block, written as a
  Chrome/Perfetto trace.
* :func:`span` — a named span (``petal.*``) around a stage of a fit,
  recorded only while a ``torch.profiler`` records: a
  ``user_annotation`` event on the profiler's own timeline, beside the
  kernels and copies it launched.  With no profiler it costs one flag
  read.
* ``FitStats`` / :func:`record_fit` — wall clock and counters of the
  most recent fit (``model.last_fit_stats_``), inside a ``petal.fit``
  span.  On CUDA the clock is read after ``torch.cuda.synchronize()``,
  so it covers the device work and not only its enqueueing.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["trace", "span", "FitStats", "record_fit"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """``torch.profiler.record_function(name)`` while a profiler records,
    else one shared no-op context.  ``name`` is a static ``petal.*``
    string; the span's parent is the span that encloses it on its
    thread.  The test is the flag the profiler sets for the whole process
    as it starts and clears as it stops, so a worker thread sees it too.

    >>> with span("petal.example"):
    ...     pass
    >>> span("petal.example") is span("petal.other")  # no profiler: no-op
    True
    """
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, plus CUDA when available) and write
    ``trace.json`` under ``log_dir``; waits for the device before the
    profile closes.  Every thread is profiled, not only the caller's, so
    the spans of a stream's feed worker land on its own thread."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=every_thread) as prof:
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
    """Time a fit on ``device`` inside a ``petal.fit`` span and attach
    ``last_fit_stats_`` to the model.  A streamed fit, whose n and d are
    known only after its pass, passes 0 and sets them on the stats.

    >>> class M: pass
    >>> m = M()
    >>> with record_fit(m, n=100, d=8, device="cpu") as stats:
    ...     stats.extra["note"] = "work happens here"
    >>> m.last_fit_stats_.n_samples, m.last_fit_stats_.n_features
    (100, 8)
    """
    with span("petal.fit"):
        _sync(device)
        t0 = time.perf_counter()
        stats = FitStats(n_samples=n, n_features=d)
        try:
            yield stats
        finally:
            _sync(device)
            stats.wall_time_s = time.perf_counter() - t0
            model.last_fit_stats_ = stats
