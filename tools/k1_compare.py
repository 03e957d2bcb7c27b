#!/usr/bin/env python3
"""Time K1, the fused sketch + moments kernel of the PyTorch port, at the
flagship shapes, and the fits around it.

    python3 tools/k1_compare.py [--tree DIR] [--label NAME] [--reps 20]

DIR is the root of a checkout of this repository (default: the one
holding this script).  Its ``petal_decomposition_tpu_torch`` is imported
and its K1 is built, so two checkouts are compared on one card by running
this script once for each, in separate processes.  The data is
``chip_smoke.make_data`` (X 1,000,000 × 1024 float32) and a Gaussian W
1024 × 42, from ``chip_smoke.py``'s seeds.

Prints one JSON object with the card's name and power limit: K1's device
time over ``--reps`` runs by CUDA events (median, min, max), ``x @ w``
alone and the plain version beside it, K1's Y error against the plain
version, and the median of 5 ``RandomizedPca(32)`` fits' wall time on the
data route (``range_finder("gram").gram_projection("data")``, one K1
launch a fit) and by the default constructor (no kernel).  Needs a CUDA
card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "tools"))

from k3_compare import _load_smoke, spread_ms  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = _load_smoke()
    sys.path.insert(0, str(args.tree.resolve()))
    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    k1.build()
    x = cs.make_data(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED + 1)
    w = torch.randn(cs.D, cs.L, generator=g, device=dev)

    y, _, _ = k1.fused_sketch_moments(x, w)
    y_p, _, _ = k1._sketch_moments_plain(x, w)
    y_err = float((y - y_p).abs().max() / y_p.abs().max())
    del y, y_p
    ms, lo, hi = spread_ms(lambda: k1.fused_sketch_moments(x, w), args.reps)
    out = {
        "label": args.label or str(args.tree), "nvidia_smi": smi,
        "x": list(x.shape), "w": list(w.shape),
        "k1_ms": ms, "k1_ms_min": lo, "k1_ms_max": hi,
        "x_times_w_ms": spread_ms(lambda: x @ w, args.reps)[0],
        "plain_ms": spread_ms(lambda: k1._sketch_moments_plain(x, w),
                              args.reps)[0],
        "y_rel_err_vs_plain": y_err,
    }

    def fit_ms(make):
        make().fit(x)  # warm-up
        times = []
        for _ in range(5):
            model = make()
            model.fit(x)
            times.append(model.last_fit_stats_.wall_time_s * 1e3)
        return {"median": statistics.median(times), "all": times}

    out["data_route_fit_ms"] = fit_ms(
        lambda: api.RandomizedPcaBuilder(cs.K).seed(cs.SEED)
        .range_finder("gram").gram_projection("data").device("cuda").build()
    )
    out["default_fit_ms"] = fit_ms(
        lambda: api.RandomizedPca(cs.K, seed=cs.SEED, device="cuda"))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
