#!/usr/bin/env python3
"""Find what K2's design choices buy, and where its time goes, on the card.

    python3 tools/k2_variants.py [--reps 20]

Builds variants of K2 (``csrc/jacobi_svd.cu`` with the shared
``csrc/jacobi_block.cuh``; generated copies under ``build/k2_variants/``,
never in ``csrc/``) and runs each on seeded Gaussian float32 panels with
column scales 1 to 10 (1024×43, the randomized fit's Bᵀ shape; 256×256;
632×632; 20,000×50, rows split over CTAs), under the package's plan:

* ``kernel``: the sources as they are;
* ``c_rounds_to_1``: the rotation applied as fma(c − 1, x, x − s·y), so
  (c − 1)·x, below half an ulp of x, is lost to the first rounding;
* ``row_guards``: each register row tested against the thread's row
  count, as K3 does;
* ``copy8``: every copy into shared memory 8 bytes, none 16.

For each: the median ms of ``--reps`` runs to convergence and its sweeps,
the ms a sweep at 6 sweeps with the stop rule off, σ against float64
LAPACK (relative to σ₁), ‖A·V‖_F / ‖A‖_F − 1 (what a rotation that is not
orthogonal adds up to), and whether the outputs equal ``kernel``'s
bitwise.  Then ``probe``, a copy of the kernel with clock64 counters in
thread 0 of CTA 0: the SM cycles of each phase of an outer step and of an
inner step, at 6 sweeps.  Prints one JSON object with the card's name and
power limit.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "tools"))

from k3_compare import spread_ms  # noqa: E402

CSRC = HERE / "petal_decomposition_tpu_torch" / "csrc"
OUT = HERE / "build" / "k2_variants"
PANELS = ((1024, 43), (256, 256), (632, 632), (20_000, 50))
FIXED_SWEEPS = 6

_ROTATE = ("  x = xa + fmaf(r.x, xa, -r.y * xb);\n"
           "  y = xb + fmaf(r.x, xb, r.y * xa);",
           "  x = fmaf(r.x, xa, fmaf(-r.y, xb, xa));\n"
           "  y = fmaf(r.x, xb, fmaf(r.y, xa, xb));")
_GUARDS = ("  static constexpr bool kRowGuards = false;",
           "  static constexpr bool kRowGuards = true;")
_COPY = ("      if (((ldsrc | row0 | rows | p.ld) & 3) == 0) {",
         "      if (false) {")

# The probe: counters in thread 0 of CTA 0, summed over the launch.
_ADD = ("if (blockIdx.x == 0 && threadIdx.x == 0) "
        "atomicAdd(&g_probe[%d], (unsigned long long)(%s));")
INNER = ("dots", "barrier", "partial_sums", "rotation", "apply", "move")
OUTER = ("load_and_pull", "inner_sweep", "push_and_v_update", "grid_sync")
_PROBE = [
    ("namespace {\n\nconstexpr int kMaxW2",
     "namespace {\n__device__ unsigned long long g_probe[16];\n"
     "constexpr int kMaxW2"),
    ("    T* buf = red + (ks & 1) * 3 * W * nwa;\n"
     "    if (panel) warp_dots<T, W2>(p, x, buf, nwa);\n"
     "    __syncthreads();\n",
     "    long long s0 = clock64();\n"
     "    T* buf = red + (ks & 1) * 3 * W * nwa;\n"
     "    if (panel) warp_dots<T, W2>(p, x, buf, nwa);\n"
     "    long long s1 = clock64();\n    __syncthreads();\n"
     "    long long s2 = clock64();\n"),
    ("    if (R > 1) {\n      // Rows split",
     "    long long s3 = clock64();\n    if (R > 1) {\n      // Rows split"),
    ("      mine[lane] = rotation(app, aqq, apq, p.eps);\n    }\n"
     "    __syncwarp();\n",
     "      mine[lane] = rotation(app, aqq, apq, p.eps);\n    }\n"
     "    __syncwarp();\n    long long s4 = clock64();\n"),
    ("    __syncwarp();\n    // The circle method's move",
     "    __syncwarp();\n    long long s5 = clock64();\n"
     "    // The circle method's move"),
    ("      x[k][1] = last;\n    }\n  }\n}",
     "      x[k][1] = last;\n    }\n    long long s6 = clock64();\n    "
     + " ".join(_ADD % (8 + i, f"s{i + 1} - s{i}") for i in range(6))
     + "\n  }\n}"),
    ("      for (int t = 0; t < steps; ++t) {\n        const bool first",
     "      for (int t = 0; t < steps; ++t) {\n        long long o0 = clock64();\n"
     "        const bool first"),
    ("        T apq_max = T(0), nrm_max = T(0);\n"
     "        inner_sweep<T, W2>(p, x, panel, cs, red, apq_max, nrm_max, ks, "
     "grid);\n",
     "        T apq_max = T(0), nrm_max = T(0);\n        long long o1 = clock64();\n"
     "        inner_sweep<T, W2>(p, x, panel, cs, red, apq_max, nrm_max, ks, "
     "grid);\n        long long o2 = clock64();\n"),
    ("        grid.sync();\n      }\n      if (warp == 0) {",
     "        long long o3 = clock64();\n        grid.sync();\n"
     "        long long o4 = clock64();\n        "
     + "".join(_ADD % (i, f"o{i + 1} - o{i}") for i in range(4)) + _ADD % (4, "1")
     + "\n      }\n      if (warp == 0) {"),
]
_PROBE_READ = ('\nextern "C" int petal_probe(void* out, int reset) {\n'
               "  unsigned long long z[16] = {};\n"
               "  if (reset) return (int)cudaMemcpyToSymbol(g_probe, z, "
               "sizeof(z));\n"
               "  return (int)cudaMemcpyFromSymbol(out, g_probe, sizeof(z));\n"
               "}\n")

VARIANTS = {
    "kernel": [],
    "c_rounds_to_1": [_ROTATE],
    "row_guards": [_GUARDS],
    "copy8": [_COPY],
    "probe": _PROBE,
}


def build(name: str) -> ctypes.CDLL:
    from petal_decomposition_tpu_torch.ops.kernels import _build

    header = (CSRC / "jacobi_block.cuh").read_text()
    for old, new in VARIANTS[name]:
        if header.count(old) != 1:
            raise RuntimeError(f"variant {name}: the source has changed")
        header = header.replace(old, new)
    src = (CSRC / "jacobi_svd.cu").read_text()
    if name == "probe":
        src += _PROBE_READ
    d = OUT / name
    d.mkdir(parents=True, exist_ok=True)
    (d / "jacobi_block.cuh").write_text(header)
    (d / "jacobi_svd.cu").write_text(src)
    so = d / "lib.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                    str(d / "jacobi_svd.cu")], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.petal_error_string.argtypes = [ctypes.c_int]
    lib.petal_error_string.restype = ctypes.c_char_p
    fn = lib.petal_jacobi_svd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_variants: no CUDA device", file=sys.stderr)
        return 2
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_block,
        jacobi_kernels as k2,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    probe = libs.pop("probe")
    probe.petal_probe.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rng = np.random.default_rng(20261016)
    out = {}
    for m, n in PANELS:
        a_np = (rng.standard_normal((m, n))
                * np.linspace(1, 10, n)).astype(np.float32)
        a = torch.from_numpy(a_np).cuda()
        a64 = a_np.astype(np.float64)
        s_ref = np.linalg.svd(a64, compute_uv=False)
        block_plan = k2.plan(m, n)
        thr = k2.threads(2 * block_plan[0], block_plan[3])

        def run(lib, sweeps=30, tol=k2._tol(m, n)):
            return jacobi_block.launch(lib, lib.petal_jacobi_svd_f32, a,
                                       sweeps, block_plan, thr, k2.EPS, tol)

        rows, base = {}, run(libs["kernel"])
        for name, lib in libs.items():
            a_rot, v, off = run(lib)
            ar = a_rot.double().cpu().numpy()
            s = np.sort(np.linalg.norm(ar, axis=0))[::-1]
            sweeps = next(k for k in range(1, 31)
                          if float(run(lib, k)[2]) <= k2._tol(m, n))
            rows[name] = {
                "ms": spread_ms(lambda lib=lib: run(lib), args.reps)[0],
                "sweeps": sweeps,
                "ms_per_sweep": spread_ms(
                    lambda lib=lib: run(lib, FIXED_SWEEPS, -1.0),
                    args.reps)[0] / FIXED_SWEEPS,
                "sigma_rel_err": float(np.abs(s - s_ref).max() / s_ref[0]),
                "frobenius_growth": float(np.linalg.norm(ar)
                                          / np.linalg.norm(a64) - 1),
                "bitwise_equal_to_kernel": all(
                    torch.equal(x, y) for x, y in zip((a_rot, v, off), base)),
            }
        probe.petal_probe(None, 1)
        run(probe, FIXED_SWEEPS, -1.0)
        torch.cuda.synchronize()
        counts = (ctypes.c_ulonglong * 16)()
        probe.petal_probe(counts, 0)
        outer = max(counts[4], 1)
        inner = outer * (2 * block_plan[0] - 1)
        rows["probe_cycles"] = {
            "outer_step": {k: counts[i] / outer for i, k in enumerate(OUTER)},
            "inner_step": {k: counts[8 + i] / inner
                           for i, k in enumerate(INNER)},
        } if counts[4] else "P = 1: no outer steps"
        out[f"{m}x{n}"] = {"plan_w_P_R": list(block_plan[:3]), **rows}
    print(json.dumps({"nvidia_smi": smi, "panels": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
