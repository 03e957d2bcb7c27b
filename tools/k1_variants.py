#!/usr/bin/env python3
"""Find what bounds K1, the fused sketch + moments kernel, on the card.

    python3 tools/k1_variants.py [--reps 20] [--rounds 3]

Builds variants of ``petal_decomposition_tpu_torch/csrc/sketch_moments.cu``
with parts of the work taken out (generated copies under ``build/k1_variants/``,
never in ``csrc/``), and times each at X 1,000,000 × 1024 float32 and W
1024 × 42 (``chip_smoke.make_data`` and its seeds), in turns over
``--rounds`` rounds:

* ``kernel``: the source as it is;
* ``no_products``: without the three wgmma products;
* ``no_moments``: without the column sums and ‖X‖²;
* ``stream``: neither, so X and the W slices only pass through the ring;
* ``stream_no_w``: ``stream`` without the W slices.

Beside them: ``x.sum()``, ``x.sum(0)``, ``x.clone()`` and ``x @ w``, what
PyTorch's own kernels take to read X, and, from ``torch.profiler``, the
device time of each kernel one call of the package's K1 launches.  The
variants' outputs are wrong by design; only ``kernel`` is checked, against
the plain version.  Prints one JSON object with the card's name and power
limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from k3_compare import _load_smoke, spread_ms  # noqa: E402

SOURCE = HERE / "petal_decomposition_tpu_torch" / "csrc" / "sketch_moments.cu"
OUT = HERE / "build" / "k1_variants"

_PRODUCTS = (
    "          mma_row<N>(acc[mt], a[mt][s][0], dh);  // xh·wh\n"
    "          mma_row<N>(acc[mt], a[mt][s][1], dh);  // xl·wh\n"
    "          mma_row<N>(acc[mt], a[mt][s][0], dl);  // xh·wl\n", "")
_MOMENTS = ("      if (moments) {", "      if (false) {")
_W_SLICES = [
    ("        mbar_expect_tx(full, C::X_BYTES + C::W_BYTES);",
     "        mbar_expect_tx(full, C::X_BYTES);"),
    ("        bulk_load(base + C::W_OFF + stage * C::W_BYTES, wsrc, C::W_BYTES,\n"
     "                  full);\n      } else {", "      } else {"),
]
VARIANTS = {
    "kernel": [],
    "no_products": [_PRODUCTS],
    "no_moments": [_MOMENTS],
    "stream": [_PRODUCTS, _MOMENTS],
    "stream_no_w": [_PRODUCTS, _MOMENTS, *_W_SLICES],
}


def build(name: str) -> ctypes.CDLL:
    from petal_decomposition_tpu_torch.ops.kernels import _build

    src = SOURCE.read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: the source has changed")
        src = src.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, so = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.petal_error_string.argtypes = [ctypes.c_int]
    lib.petal_error_string.restype = ctypes.c_char_p
    return lib


def call_with(lib, x, w):
    """The package's wrapper, launching ``lib`` in place of its own
    build of the source."""
    from petal_decomposition_tpu_torch.ops.kernels import _build
    from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1

    real = _build.load_library
    _build.load_library = lambda name, sources: lib
    try:
        return k1.fused_sketch_moments(x, w)[0]
    finally:
        _build.load_library = real


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 2
    from petal_decomposition_tpu_torch.ops.kernels import sketch_kernel as k1

    cs = _load_smoke()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    dev = torch.device("cuda")
    x = cs.make_data(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(cs.SEED + 1)
    w = torch.randn(cs.D, cs.L, generator=g, device=dev)
    y_p, _, _ = k1._sketch_moments_plain(x, w)
    y_err = float((call_with(libs["kernel"], x, w) - y_p).abs().max()
                  / y_p.abs().max())
    del y_p

    timed = {name: (lambda lib=lib: call_with(lib, x, w))
             for name, lib in libs.items()}
    timed.update({"x.sum()": x.sum, "x.sum(0)": lambda: x.sum(0),
                  "x.clone()": x.clone, "x @ w": lambda: x @ w})
    ms = {name: [] for name in timed}
    for _ in range(args.rounds):
        for name, fn in timed.items():
            ms[name].append(spread_ms(fn, args.reps)[0])

    k1.fused_sketch_moments(x, w)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            k1.fused_sketch_moments(x, w)
        torch.cuda.synchronize()
    per_call_us = {e.key: e.device_time_total / 10
                   for e in prof.key_averages() if e.device_time_total > 0}
    print(json.dumps({
        "nvidia_smi": smi, "x": list(x.shape), "w": list(w.shape),
        "kernel_y_rel_err_vs_plain": y_err,
        "median_ms_per_round": ms,
        "median_ms": {k: statistics.median(v) for k, v in ms.items()},
        "profiler_us_per_call": per_call_us,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
