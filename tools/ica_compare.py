#!/usr/bin/env python3
"""Time in-core FastICA at BASELINE config 3 in float32 (``FastIca.fit`` of
the 100k × 64 Laplace mixture held on the card) under each
decorrelation, on one checkout of the PyTorch port.

    python3 tools/ica_compare.py [--tree DIR] [--label NAME] [--reps 6]

DIR is the root of a checkout of this repository (default: the one
holding this script).  Its ``petal_decomposition_tpu_torch`` is imported
and its kernels are built, so two checkouts are compared on one card by
running this script for each in separate processes, interleaved (A B B
A).  The data and the models come from ``chip_smoke.py`` beside this
script (``ica32_data``, ``ica_model``), from a fixed seed.  For
``decorrelation="ns"`` (the card's default) and ``"eigh"``, in turns
(ns, eigh, eigh, ns, ...): each of ``--reps`` fits' wall time
(``last_fit_stats_``, after one warm-up fit of each), its n_iter, and
the fit's K4 launches where the tree has K4.  Prints one JSON object,
with the card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def _load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_helpers", HERE / "chip_smoke.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=6)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ica_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = _load_smoke()
    sys.path.insert(0, str(args.tree.resolve()))
    import petal_decomposition_tpu_torch as api

    try:
        k4 = importlib.import_module(
            "petal_decomposition_tpu_torch.ops.kernels.ica_update")
    except ModuleNotFoundError:
        k4 = None
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device(cs.CUDA)
    x = cs.ica32_data(dev)
    modes = ("ns", "eigh")
    for mode in modes:  # warm-up: builds, cuBLAS and cuSOLVER handles
        cs.ica_model(api, dev, decorrelation=mode).fit(x)
    rows = {m: {"fit_ms": [], "n_iter": [], "k4_launches": []}
            for m in modes}
    for rep in range(args.reps):
        for mode in (modes if rep % 2 == 0 else modes[::-1]):
            before = k4.launches if k4 else 0
            m = cs.ica_model(api, dev, decorrelation=mode).fit(x)
            row = rows[mode]
            row["fit_ms"].append(m.last_fit_stats_.wall_time_s * 1e3)
            row["n_iter"].append(m.n_iter_)
            row["k4_launches"].append(k4.launches - before if k4 else None)
    for row in rows.values():
        row["median_ms"] = statistics.median(row["fit_ms"])
    print(json.dumps({"label": args.label or str(args.tree), "card": smi,
                      "x": list(x.shape), "dtype": str(x.dtype),
                      "fits": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
