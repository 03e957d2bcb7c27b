#!/usr/bin/env python3
"""Time streamed FastICA at BASELINE config 3 (``FastIca.fit_batched`` of
the 100k × 64 Laplace mixture from host blocks of 65536 rows), and the
in-core fit beside it, on one checkout of the PyTorch port.

    python3 tools/stream_ica_compare.py [--tree DIR] [--label NAME]
                                        [--reps 5]

DIR is the root of a checkout of this repository (default: the one
holding this script).  Its ``petal_decomposition_tpu_torch`` is imported
and its kernels are built, so two checkouts are compared on one card by
running this script for each in separate processes, interleaved (A B B
A).  The data and the models come from ``chip_smoke.py`` beside this
script (``ica_sources``, ``ica_model``), from a fixed seed.  For float64
at full iteration precision and at the card's defaults: each of
``--reps`` fits' wall time (``last_fit_stats_``, after one warm-up), its
n_iter, and the in-core fit's times.  Prints one JSON object, with the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
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
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("stream_ica_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = _load_smoke()
    sys.path.insert(0, str(args.tree.resolve()))
    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops.kernels import jacobi_f64_kernel

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    jacobi_f64_kernel.build()
    s, a = cs.ica_sources(torch.device(cs.CUDA))
    x = s @ a.mT
    host = x.cpu().numpy()
    parts = [host[i:i + 65536] for i in range(0, host.shape[0], 65536)]

    def stream():
        return iter(parts)

    out = {"label": args.label or str(args.tree), "card": smi,
           "x": list(host.shape), "fits": {}}
    for name, knobs in (("f64_full", {"iteration_precision": "full"}),
                        ("f64_defaults", {})):
        row = {"knobs": knobs}
        for how, fit in (("stream", lambda m: m.fit_batched(stream)),
                         ("in_core", lambda m: m.fit(x))):
            fit(cs.ica_model(api, cs.CUDA, **knobs))  # warm-up
            ms, iters = [], set()
            for _ in range(args.reps):
                m = fit(cs.ica_model(api, cs.CUDA, **knobs))
                ms.append(m.last_fit_stats_.wall_time_s * 1e3)
                iters.add(m.n_iter_)
            row[how] = {"fit_ms": ms, "n_iter": sorted(iters)}
        out["fits"][name] = row
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
