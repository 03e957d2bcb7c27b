"""The command line of ``run.py``: arguments, the look for the cards the
cell asks for, the cell's launcher (``launchers/<traffic launcher>.py``,
which returns the result) and the result's last lines."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

from . import harness, imports, spec

EXIT_NO_CARD = 3
EXIT_FORBIDDEN = 4
EXIT_NO_PROGRAM = 5


def parse(argv):
    ap = argparse.ArgumentParser(prog="port_bench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths
    (the program's own CUDA libraries already go to ``build/torch_kernels``
    there)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton_cache")


def check_lines(checks: dict) -> list[str]:
    return [f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for name, c in checks.items()]


def main(argv, t_start: float) -> int:
    args = parse(argv)
    root = Path(__file__).resolve().parents[2]
    bench = spec.load(root)
    cell = spec.cell(root, bench, args.workload)
    cache_dirs(root)
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded at start: {loaded}", file=sys.stderr)
        return EXIT_FORBIDDEN
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return EXIT_NO_CARD
    try:
        import petal_decomposition_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not beside the benchmark: {e}", file=sys.stderr)
        return EXIT_NO_PROGRAM
    launcher = spec.module(root, "launchers", cell.traffic["launcher"])
    try:
        result = launcher.launch(root, cell, args, t_start)
    except harness.ForbiddenModules as e:
        print(f"forbidden modules loaded by the run: {e}", file=sys.stderr)
        return EXIT_FORBIDDEN
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
