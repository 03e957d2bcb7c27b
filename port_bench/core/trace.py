"""``torch.profiler`` around a few fits, and the reduction of its Chrome
trace to what the per-layer readers and the ``breakdown`` need.

Device intervals are the trace's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; host activity its ``cpu_op``, ``cuda_runtime`` and
``cuda_driver`` events.  Times are in seconds.
"""

from __future__ import annotations

import heapq
import json
from collections import defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
TOP = 10


@dataclass
class Event:
    cat: str
    name: str
    start: float
    dur: float

    @property
    def end(self) -> float:
        return self.start + self.dur


@dataclass
class Summary:
    """A traced window: its device and host events, its span, and the
    union of the device's busy intervals."""

    device: list = field(default_factory=list)
    host: list = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    busy: list = field(default_factory=list)

    def kernels(self) -> list:
        return [e for e in self.device if e.cat == "kernel"]

    def copies(self, direction: str) -> list:
        """Memory copies whose name holds ``direction`` (``"HtoD"``)."""
        return [e for e in self.device
                if e.cat == "gpu_memcpy" and direction in e.name]


def events_from_chrome(trace: dict) -> list[Event]:
    out = []
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS or cat in HOST_CATS:
            out.append(Event(cat, e.get("name", ""), float(e["ts"]) * 1e-6,
                             float(e["dur"]) * 1e-6))
    return out


def union(intervals) -> list[tuple[float, float]]:
    """Merged ``(start, end)`` intervals, sorted."""
    merged: list[list[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(events: list[Event]) -> Summary:
    dev = [e for e in events if e.cat in DEVICE_CATS]
    host = [e for e in events if e.cat in HOST_CATS]
    s = Summary(device=dev, host=host)
    if not events:
        return s
    start = min(e.start for e in events)
    end = max(e.end for e in events)
    s.window_s = end - start
    s.busy = union((e.start, e.end) for e in dev)
    s.busy_s = sum(e - b for b, e in s.busy)
    return s


def summarize_file(path) -> Summary:
    with open(path) as f:
        return summarize(events_from_chrome(json.load(f)))


def device_ops(s: Summary, top: int = TOP) -> list:
    """``[[name, seconds], ...]``: the device operations that took most
    time, summed by name."""
    tot = defaultdict(float)
    for e in s.device:
        tot[e.name] += e.dur
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(s: Summary, top: int = TOP) -> list:
    """``[[host activity, seconds], ...]``: the device's idle time between
    its busy intervals, summed by what the host was doing at each gap's
    middle (the innermost host event covering it, else ``"host"``)."""
    gaps = [(e0, s1) for (_, e0), (s1, _) in zip(s.busy, s.busy[1:]) if s1 > e0]
    mids = sorted(((a + b) / 2, b - a) for a, b in gaps)
    hosts = sorted(s.host, key=lambda e: e.start)
    active: list = []  # (duration, end, name): the innermost on top
    tot = defaultdict(float)
    i = 0
    for mid, length in mids:
        while i < len(hosts) and hosts[i].start <= mid:
            h = hosts[i]
            heapq.heappush(active, (h.dur, h.end, h.name))
            i += 1
        while active and active[0][1] < mid:
            heapq.heappop(active)
        tot[active[0][2] if active else "host"] += length
    return [[n, t] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def profile(torch, fn, path):
    """Run ``fn`` under ``torch.profiler`` (host, and the card where there
    is one), write the Chrome trace to ``path`` and return its
    :class:`Summary` and ``fn``'s result."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        result = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    return summarize_file(path), result
