"""``BENCHMARK.json`` and the files each of its names leads to.

A cell names a configuration and a traffic mix; a traffic mix names the
placement of its rows and its launcher; each metric names its reader.
Nothing here lists them: a new configuration, mix, placement, launcher,
cell or metric is new files plus new entries in ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = "port_bench"

NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH_RE = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_END_TO_END = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
WORKLOAD_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config_name: str
    traffic_name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def load(root: Path) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _line(text) -> bool:
    return (isinstance(text, str) and 1 <= len(text) <= 200
            and "\n" not in text and "\t" not in text)


def validate(bench: dict) -> list[str]:
    """The contract's rules on names, units, keys and sizes that the file
    alone can break: the faults found, or an empty list."""
    bad = []
    if set(bench) != KEYS:
        bad.append(f"top-level keys {sorted(bench)}")
    cmd = bench.get("command", [])
    if not (isinstance(cmd, list) and 1 <= len(cmd) <= 32
            and all(_line(w) for w in cmd)):
        bad.append("command")
    for p in bench.get("paths", []):
        if not PATH_RE.match(p) or p.startswith("/") or ".." in p.split("/"):
            bad.append(f"path {p!r}")
    if not 1 <= len(bench.get("paths", [])) <= 16:
        bad.append("paths count")
    rs = bench.get("run_seconds")
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        bad.append("run_seconds")
    sections = (("configs", CONFIG_KEYS, 24), ("workloads", WORKLOAD_KEYS, 24),
                ("end_to_end", E2E_KEYS, 16), ("per_layer", LAYER_KEYS, 128))
    for key, allowed, most in sections:
        entries = bench.get(key, [])
        if not 1 <= len(entries) <= most:
            bad.append(f"{key} count {len(entries)}")
        names = [e.get("name") for e in entries]
        if len(set(names)) != len(names):
            bad.append(f"{key}: a name twice")
        for e in entries:
            extra = set(e) - allowed - ({"workloads"} if key in (
                "end_to_end", "per_layer") else set())
            if extra or not allowed <= set(e):
                bad.append(f"{key} {e.get('name')}: keys {sorted(e)}")
            if not NAME_RE.match(str(e.get("name", ""))):
                bad.append(f"{key}: name {e.get('name')!r}")
            if key in ("end_to_end", "per_layer"):
                if not UNIT_RE.match(str(e.get("unit", ""))):
                    bad.append(f"{e['name']}: unit {e.get('unit')!r}")
                if e.get("better") not in ("lower", "higher"):
                    bad.append(f"{e['name']}: better")
                srcs = SOURCES_END_TO_END if key == "end_to_end" else SOURCES
                if e.get("source") not in srcs:
                    bad.append(f"{e['name']}: source")
            if key == "end_to_end":
                b = e.get("bound")
                if not (isinstance(b, (int, float)) and 0.01 <= b <= 0.25):
                    bad.append(f"{e['name']}: bound {b}")
            if key == "per_layer" and not _line(e.get("layer")):
                bad.append(f"{e['name']}: layer")
            if key in ("configs", "workloads") and not _line(e.get("why")):
                bad.append(f"{e['name']}: why")
            if key == "configs":
                if not _line(e.get("source")):
                    bad.append(f"{e['name']}: source")
                red = e.get("reduced", [])
                if len(red) > 16 or not all(NAME_RE.match(r) for r in red):
                    bad.append(f"{e['name']}: reduced")
            if key == "workloads":
                for k in ("config", "traffic"):
                    if not NAME_RE.match(str(e.get(k, ""))):
                        bad.append(f"{e['name']}: {k}")
                if e.get("chips") not in (1, 4):
                    bad.append(f"{e['name']}: chips")
    pairs = [(w.get("config"), w.get("traffic"))
             for w in bench.get("workloads", [])]
    if len(set(pairs)) != len(pairs):
        bad.append("a configuration and traffic pair twice")
    return bad


def _read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, bench: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic and limits read
    from their files, and the metrics it reports."""
    root = Path(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {', '.join(sorted(work))})")
    w = work[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def reports(metric):
        return name in metric.get("workloads", [name])

    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        traffic_name=w["traffic"],
        config=_read_json(root / cfg_entry["file"]),
        traffic=_read_json(root / BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_read_json(root / BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )


def module(root: Path, kind: str, name: str):
    """The module ``<kind>/<name>.py``: a metric's reader
    (``end_to_end``, ``metrics``), a traffic's placement of its rows
    (``placements``) or its launcher (``launchers``).  A name may hold
    dots, so the module is loaded from its path."""
    path = Path(root) / BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"port_bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no module {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
