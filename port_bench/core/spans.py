"""The program's own spans in a traced run's Chrome trace, and what they
hold.

Under ``torch.profiler`` the program marks the stages of a fit with
``petal.*`` spans (``petal_decomposition_tpu_torch/utils/profiling.py::
span``): ``user_annotation`` events on the profiler's timeline, each on
the thread that opened it.  This module reads them from the trace file a
traced run wrote (:func:`.trace.profile`), beside the kernels and the
host launches that carry the same correlation id, and keeps them apart
from :class:`.trace.Summary`, whose readings they do not enter:

* :func:`kernels_by_span` — each kernel under the innermost span that
  holds its host launch;
* :func:`idle_by_span` — the device's idle gaps under the innermost span
  of the fitting thread that covers each gap's middle;
* :func:`host_s` — the host time of a span, summed.

``python3 port_bench/core/spans.py <trace.json>`` prints the last two
lines of a trace file.  Times are in seconds.
"""

from __future__ import annotations

import functools
import json
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):  # run as a script
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from port_bench.core import harness, trace  # noqa: E402

PREFIX = "petal."
FIT = "petal.fit"
OUTSIDE = "outside spans"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


@dataclass(frozen=True)
class Span:
    name: str
    tid: object
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Spans:
    """A trace's ``petal.*`` spans; its kernels as ``(start, dur,
    correlation)``; each correlation id's host launch as ``(tid,
    time)``."""

    spans: list = field(default_factory=list)
    kernels: list = field(default_factory=list)
    launches: dict = field(default_factory=dict)

    def main_tid(self):
        """The thread that ran the fits: the one holding the most
        ``petal.fit`` time, else the most span time; None without
        spans."""
        for names in ((FIT,), None):
            tot = defaultdict(float)
            for s in self.spans:
                if names is None or s.name in names:
                    tot[s.tid] += s.dur
            if tot:
                return max(tot, key=tot.get)
        return None

    def on(self, tid) -> list:
        return [s for s in self.spans if s.tid == tid]


def from_chrome(doc: dict) -> Spans:
    out = Spans()
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        start, dur = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation" and e.get("name", "").startswith(PREFIX):
            out.spans.append(Span(e["name"], e.get("tid"), start, dur))
        elif cat == "kernel" and corr is not None:
            out.kernels.append((start, dur, corr))
        elif cat in LAUNCH_CATS and corr is not None:
            out.launches[corr] = (e.get("tid"), start)
    return out


def innermost(spans: list, times: list) -> list:
    """For each of ``times``, the innermost of ``spans`` (one thread's,
    which nest) that covers it, or None; in the order of ``times``."""
    order = sorted(spans, key=lambda s: (s.start, -s.dur))
    found: list = [None] * len(times)
    stack: list = []
    i = 0
    for k in sorted(range(len(times)), key=times.__getitem__):
        t = times[k]
        while i < len(order) and order[i].start <= t:
            while stack and stack[-1].end < order[i].start:
                stack.pop()
            stack.append(order[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        found[k] = stack[-1].name if stack else None
    return found


def kernels_by_span(sp: Spans) -> dict:
    """``{span name: [(start, end), ...]}``: each kernel under the
    innermost span that holds its host launch (kernels launched outside
    every span under :data:`OUTSIDE`)."""
    by_tid = defaultdict(list)
    for start, dur, corr in sp.kernels:
        launch = sp.launches.get(corr)
        if launch is not None:
            by_tid[launch[0]].append((launch[1], (start, start + dur)))
    out = defaultdict(list)
    for tid, items in by_tid.items():
        names = innermost(sp.on(tid), [t for t, _ in items])
        for name, (_, interval) in zip(names, items):
            out[name or OUTSIDE].append(interval)
    return dict(out)


def device_s(intervals) -> float:
    """The time the union of ``intervals`` covers."""
    return sum(e - s for s, e in trace.union(intervals))


def host_s(sp: Spans, name: str) -> float:
    """The summed duration of the spans named ``name`` on the fitting
    thread."""
    tid = sp.main_tid()
    return sum(s.dur for s in sp.spans if s.name == name and s.tid == tid)


def count(sp: Spans, name: str) -> int:
    tid = sp.main_tid()
    return sum(1 for s in sp.spans if s.name == name and s.tid == tid)


def idle_by_span(summary: trace.Summary, sp: Spans) -> list:
    """``[[span name, seconds], ...]``: the device's idle time between its
    busy intervals, each gap under the innermost span of the fitting
    thread that covers its middle, else :data:`OUTSIDE`; largest
    first."""
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(summary.busy,
                                                 summary.busy[1:]) if s1 > e0]
    names = innermost(sp.on(sp.main_tid()), [(a + b) / 2 for a, b in gaps])
    tot = defaultdict(float)
    for name, (a, b) in zip(names, gaps):
        tot[name or OUTSIDE] += b - a
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])]


@functools.lru_cache(maxsize=1)
def _read(path: str, mtime_ns: int):
    with open(path) as f:
        doc = json.load(f)
    return trace.summarize(trace.events_from_chrome(doc)), from_chrome(doc)


def _same(a: trace.Summary, b: trace.Summary) -> bool:
    return (a.window_s, a.busy_s, len(a.device), len(a.host)) == (
        b.window_s, b.busy_s, len(b.device), len(b.host))


def of_run(run) -> Spans | None:
    """The spans of a traced run: read from the newest trace file of its
    cell (where :func:`.harness.run_cell` wrote it), if that file reduces
    to the run's own ``summary``; else None.  The first reader of a run
    prints ``{"idle_by_span": ...}`` on an earlier line of the run's
    standard output."""
    if run.summary is None:
        return None
    files = sorted(harness.trace_dir(run.root).glob(f"{run.cell.name}-*.json"),
                   key=lambda p: p.stat().st_mtime_ns)
    if not files:
        return None
    key = (str(files[-1]), files[-1].stat().st_mtime_ns)
    summary, sp = _read(*key)
    if not _same(summary, run.summary):
        return None
    _announce(*key)
    return sp


@functools.lru_cache(maxsize=1)
def _announce(path: str, mtime_ns: int) -> None:
    summary, sp = _read(path, mtime_ns)
    harness.log({"idle_by_span": idle_by_span(summary, sp)})


def main(argv) -> int:
    summary, sp = _read(argv[0], 0)
    print(json.dumps({"idle_by_span": idle_by_span(summary, sp)}))
    print(json.dumps({"kernel_s_by_span": sorted(
        ([n, device_s(iv)] for n, iv in kernels_by_span(sp).items()),
        key=lambda kv: -kv[1])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
