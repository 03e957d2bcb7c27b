"""Arithmetic that several metrics' readers share, so that a quantity
split by the end-to-end metric it moves is computed once."""

from __future__ import annotations

import statistics


def mean_fit_ms(run) -> float:
    """The window's total fit time over the fits it completed, in ms."""
    return sum(f.ms for f in run.fits) / len(run.fits)


def p90_fit_ms(run):
    """The 90th percentile of the window's fit times (exclusive method),
    in ms; none under ten fits."""
    ms = [f.ms for f in run.fits]
    if len(ms) < 10:
        return None
    return statistics.quantiles(ms, n=10)[8]


def mfu_pct(run):
    """The operations the configuration's algorithm needs for the window's
    fits (``counts/<family>.py``, at each fit's iterations) over their
    summed time times the card's peak at the data's dtype, in %.  The
    window's untraced fits are used: the profiler slows a launch-bound
    fit's host."""
    if run.peaks is None:
        return None
    peak = run.peaks["flop_s"][run.cfg["data"]["dtype"]]
    entry = run.traffic["entry"]
    ops = sum(run.counts.fit_ops(run.cfg, entry, f.n_iter) for f in run.fits)
    return 100.0 * ops / (sum(f.ms for f in run.fits) / 1e3 * peak)


def idle_pct(run):
    """The share of the traced fits' window in which no kernel, copy or
    memset ran on the card (the union of its intervals), in %."""
    s = run.summary
    if s is None or s.window_s <= 0 or not s.device:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
