#!/usr/bin/env python3
"""Time K2 or K3, the float32 and float64 Jacobi SVD kernels of the
PyTorch port, on the panels the port's fits hand them, and the fits
themselves.

    python3 tools/k3_compare.py [--kernel k2|k3] [--tree DIR]
                                [--label NAME] [--reps 20] [--plans]

DIR is the root of a checkout of this repository (default: the one
holding this script).  Its ``petal_decomposition_tpu_torch`` is imported
and its kernels are built, so two checkouts are compared on one card by
running this script once for each, in separate processes.  The panels
come from ``chip_smoke.k3_panels`` or ``chip_smoke.k2_panels``
(``chip_smoke.py`` at the root of the checkout holding this script),
from fixed seeds.  K3 (the default):

* the 256×256 R and the 256×256 Gram of exact float64 ``Pca(32)`` on a
  200,000 × 256 table (QR route and Gram route);
* BASELINE config 1's centered 1000 × 64 panel (direct K3);
* Bᵀ 1024 × 42 of ``RandomizedPca(32)`` on 100,000 × 1024 float64 at the
  default knobs, and the first 42 × 42 eigh of the same fit through the
  zero-pass Gram recovery;
* a centered 10,000 × 50 panel, rows split over CTAs.

K2: Bᵀ 1024 × 43 of the data-route ``RandomizedPca(32)`` on 1M × 1024
float32, the R factors of exact float32 ``Pca(32)`` on 1M × 64,
200,000 × 256 and 20,000 × 632 tables, config 1's table in float32 and
a centered 20,000 × 50 float32 panel.

For each panel: the kernel's median device time over ``--reps`` runs by
CUDA events (and its spread), ``torch.linalg.eigh`` (PSD panels) or
``torch.linalg.svd(..., driver="gesvd")`` on it, the kernel's sweeps,
the TPU kernel's order's sweeps and the bound at the fewer of the two
(``chip_smoke.jacobi_bound``).  For each fit that hands over a panel:
the median of 5 fits' wall time.  Prints one JSON object, with the
card's name and power limit.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import functools
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


def spread_ms(fn, reps):
    """(median, min, max) device ms of ``fn`` over ``reps`` runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times), min(times), max(times)


def time_plans(mod, run, cs, a, tol, reps):
    """The kernel of ``mod`` (``run`` its wrapper) on ``a`` under each
    block plan (w, P) with one row group that fits a CTA: sweeps, median
    ms and the plan's modelled cycles a sweep."""
    m, n = a.shape
    chosen, rows = mod.plan, []
    m_even = m + m % 2
    n_pad = n + n % 2
    seen = set()
    try:
        for p in range(1, min(n_pad // 2, mod.MAX_CTAS) + 1):
            w = n_pad // 2 if p == 1 else -(-n // (2 * p))
            ld = m_even if p == 1 else max(m_even, 2 * w * p)
            if w in seen or not mod._fits(m_even, 2 * w, ld):
                continue
            seen.add(w)
            mod.plan = lambda m_, n_, w=w, p=p: (w, p, 1, m_even)
            sweeps = cs.sweeps_to_converge(run, a, tol)
            ms = spread_ms(lambda: run(a), reps)[0]
            rows.append({"w": w, "P": p, "sweeps": sweeps, "ms": ms,
                         "model_cycles_per_sweep": mod.sweep_cycles(m, w, p)})
    finally:
        mod.plan = chosen
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("k2", "k3"), default="k3")
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", action="store_true",
                    help="also time each panel under every block width the "
                    "plan could choose, beside the plan's model of a sweep")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k3_compare: no CUDA device", file=sys.stderr)
        return 2
    cs = _load_smoke()
    sys.path.insert(0, str(args.tree.resolve()))
    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops import linalg
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel as k3,
        jacobi_kernels as k2,
    )

    if args.kernel == "k3":
        mod, calls = k3, cs.K3_TIMED
        run, tpu_order = k3.jacobi_svd_vmem_f64, k3._jacobi_svd_plain_f64
    else:
        mod = k2
        calls = dict.fromkeys(cs.K2_TIMED, "svd")
        run, tpu_order = k2.jacobi_svd_vmem, k2._jacobi_svd_plain

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    mod.build()

    fits = {}

    def time_fit(name, make, x):
        ms = []
        for _ in range(5):
            model = make()
            model.fit(x)
            ms.append(model.last_fit_stats_.wall_time_s * 1e3)
        fits[name] = {"fit_ms_median": statistics.median(ms), "fit_ms": ms}

    if args.kernel == "k3":
        panels = cs.k3_panels(api, k3, dev, on_fit=time_fit)
    else:
        # An older tree's K2 reaches fewer panels: it is timed on those.
        panels = cs.k2_panels(api, k2, dev, on_fit=time_fit, strict=False)
        panels = {name: a for name, a in panels.items()
                  if k2.supports(*a.shape, a.dtype)}
    torch.cuda.empty_cache()

    out = {}
    for name, a in panels.items():
        psd = calls[name] == "eigh"
        library = (functools.partial(torch.linalg.eigh, a) if psd
                   else functools.partial(torch.linalg.svd, a,
                                          full_matrices=False,
                                          driver="gesvd"))
        tol = mod._tol(*a.shape)
        sweeps = cs.sweeps_to_converge(run, a, tol)
        sweeps_tpu = cs.sweeps_to_converge(tpu_order, a, tol)
        bound_ms, bound_by = cs.jacobi_bound(a, min(sweeps, sweeps_tpu))
        ms, lo, hi = spread_ms(lambda: run(a), args.reps)
        lib_ms, _, _ = spread_ms(library, args.reps)
        row = {"shape": list(a.shape), "ms": ms, "ms_min": lo, "ms_max": hi,
               "library": "torch.linalg." + ("eigh" if psd else "svd gesvd"),
               "library_ms": lib_ms, "sweeps": sweeps,
               "sweeps_tpu_order": sweeps_tpu, "bound_ms": bound_ms,
               "bound_by": bound_by}
        if psd:
            row["eigh_route_ms"] = spread_ms(
                lambda: linalg.eigh_psd_jit_cert(a), args.reps)[0]
        if args.plans:
            row["plan"] = list(mod.plan(*a.shape))
            row["plans"] = time_plans(mod, run, cs, a, tol, args.reps)
        out[name] = row
    print(json.dumps({"label": args.label or str(args.tree),
                      "kernel": args.kernel,
                      "nvidia_smi": smi, "panels": out, "fits": fits}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
