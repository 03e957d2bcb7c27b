#!/usr/bin/env python3
"""How far FastICA's fixed-point map carries a small change of its input.

    python3 tools/ica_sensitivity.py [--device cuda] [--n 100000] [--k 64]

On BASELINE config 3's data (``chip_smoke.ica_sources``: n samples of k
Laplace sources under a κ = 4 mixing, three seeds), whitens each table
once, perturbs the whitening matrix K entrywise by a relative ε (1e-14
in float64, 1e-6 in float32: the size of the difference between two
devices' whitenings) and runs ``ica_par`` from one W₀ on both whitened
panels for each iteration count.  Prints, for each dtype, seed and
count, max |ΔW·K| relative to max |W·K| with rows sign-canonical: how
much the map has amplified ε by then.  float64 runs the eigh
decorrelation, float32 Newton–Schulz, each at full precision, as the
card-against-CPU check of ``chip_smoke.py`` does.  One JSON line a
dtype and seed, then the device's name and power limit where it is a
card.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import chip_smoke as cs  # noqa: E402

COUNTS = (5, 10, 15, 20, 30, 40)
CASES = (("float64", 1e-14, "eigh"), ("float32", 1e-6, "ns"))


def main() -> int:
    import torch

    from petal_decomposition_tpu_torch.models import fast_ica as fi
    from petal_decomposition_tpu_torch.ops.linalg import mdot

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=cs.NI)
    ap.add_argument("--k", type=int, default=cs.KI)
    args = ap.parse_args()
    dev = torch.device(args.device)
    cs.NI, cs.KI = args.n, args.k
    for seed in cs.ICA_CHECK_SEEDS:
        s, a = cs.ica_sources(dev, seed)
        x64 = s @ a.mT
        del s
        for name, eps, decorrelation in CASES:
            x = x64.to(getattr(torch, name))
            xt = (x - x.mean(0)).mT
            kmat = fi._whitening_matrix(xt, args.k, "svd")[0]
            g = torch.Generator(device=dev).manual_seed(seed)
            kp = kmat * (1 + eps * torch.randn(kmat.shape, generator=g,
                                               device=dev, dtype=x.dtype))
            w0 = torch.randn(args.k, args.k, generator=g, device=dev,
                             dtype=x.dtype)
            x1 = mdot(kmat, xt) * math.sqrt(args.n)
            x2 = mdot(kp, xt) * math.sqrt(args.n)
            out = {}
            for count in COUNTS:
                w1, _ = fi.ica_par(x1, 0.0, count, w0,
                                   decorrelation=decorrelation)
                w2, _ = fi.ica_par(x2, 0.0, count, w0,
                                   decorrelation=decorrelation)
                c1, c2 = (w1 @ kmat).double(), (w2 @ kp).double()
                c2 = c2 * torch.sign((c1 * c2).sum(1, keepdim=True))
                out[count] = cs.rel_max(c2, c1)
            print(json.dumps({"dtype": name, "seed": seed - cs.SEED,
                              "x": [args.n, args.k], "eps": eps,
                              "decorrelation": decorrelation,
                              "rel_err_by_iterations": out}), flush=True)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
