#!/usr/bin/env python3
"""Readings for the limits of ``correct``: the control and the program.

    python3 port_bench/control.py --workload <cell> --control-seeds 1,2,3 \\
        [--program-seeds 4,5,...] [--fits 3] [--fault half_the_batch]

The control is the plain reference put in the program's place, computed
one precision below the configuration's (float32 for float64, TF32 for
float32 with TF32 off), judged by the cell's own comparison at the cell's
own size.  ``--program-seeds`` adds, in the same process, the program's
readings from ``--fits`` fits a seed after the cell's warm-up, with no
measured window; ``--fault`` plants a fault in them, for the readings a
number without a control reading is held against.  One JSON line a seed
and side; the benchmark's runs do not run this.  Needs the card, as
``run.py`` does.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from port_bench.core import harness, imports, spec  # noqa: E402

LOWER = {"float64": "float32", "float32": "tf32"}


def half_the_batch(entry):
    """The entry with the fault planted: it fits the first half of the
    rows (of a tensor) or of the blocks (of a list) alone."""
    return lambda arg: entry(arg[: len(arg) // 2])


FAULTS = {"half_the_batch": half_the_batch}


def readings(cell, family, seed, device, side, fits, precision, fault=None):
    import torch

    cfg, traffic = cell.config, cell.traffic
    t0 = time.perf_counter()
    inputs = harness.make_inputs(ROOT, torch, cfg, traffic, family, seed,
                                 device)
    warm = int(traffic["warmup_fits"])
    if side == "control":
        snaps, last = family.control(cfg, traffic, seed, inputs,
                                     list(range(warm, warm + fits)), precision)
    else:
        model = family.build_model(cfg, seed, device)
        entry = getattr(model, traffic["entry"])
        if fault:
            entry = FAULTS[fault](entry)
        snaps = []
        for i in range(warm + fits):
            entry(inputs.prepare(i))
            if i >= warm:
                snaps.append((i, family.snapshot(model)))
        last = family.final(model, inputs)
        del model, entry
    checks = family.judge(cfg, traffic, seed, inputs, snaps, last,
                          cell.limits, device)
    return {"cell": cell.name, "side": side, "seed": seed,
            "precision": precision if side == "control" else "program",
            "fault": fault, "fits": len(snaps),
            "seconds": time.perf_counter() - t0,
            "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="port_bench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--program-seeds", default="")
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--fault", choices=sorted(FAULTS), default=None,
                    help="plant this fault in the program's side")
    args = ap.parse_args(argv)
    import importlib

    import torch

    cell = spec.cell(ROOT, spec.load(ROOT), args.workload)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    family = importlib.import_module(
        f"port_bench.families.{cell.config['family']}")
    precision = LOWER[cell.config["data"]["dtype"]]
    seeds = [("control", int(s)) for s in args.control_seeds.split(",") if s]
    seeds += [("program", int(s)) for s in args.program_seeds.split(",") if s]
    for side, seed in seeds:
        print(json.dumps(readings(cell, family, seed, device, side,
                                  args.fits, precision, args.fault)),
              flush=True)
        torch.cuda.empty_cache()
    loaded = imports.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {loaded}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
