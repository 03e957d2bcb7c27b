#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``petal_decomposition_tpu_torch/csrc``,
holds each against its plain PyTorch version at the shapes of the main
path, then drives the main path — ``RandomizedPca.fit`` on an in-core
1,000,000 × 1024 float32 matrix, k = 32, through the route that runs the
kernels — and checks its singular values against a float64
eigendecomposition.  Every phase prints one JSON line; any failed check
raises, so the exit code is non-zero.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, the script fails before printing any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

N, D, K, SEED = 1_000_000, 1024, 32, 20261016
L = K + 10  # the fit's sketch width (k + n_oversamples)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
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
    return statistics.median(times)


def make_data(dev):
    """Low rank plus noise with a non-zero mean: σⱼ ∝ 3·0.9ʲ over 32
    directions above a flat noise floor; mean small enough that the
    fused centering needs no guard pass."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    basis = torch.linalg.qr(torch.randn(D, K, generator=g, device=dev)).Q.T
    scale = 3.0 * 0.9 ** torch.arange(K, device=dev, dtype=torch.float32)
    x = 0.05 * torch.randn(N, D, generator=g, device=dev)
    x += (torch.randn(N, K, generator=g, device=dev) * scale) @ basis
    x += 0.1 * torch.randn(D, generator=g, device=dev)
    return x


def f64_moments(x, rows: int = 1 << 16):
    """Column sums, ‖X‖²_F and XᵀX in float64, by row chunks."""
    import torch

    cs = torch.zeros(x.shape[1], dtype=torch.float64, device=x.device)
    sq = torch.zeros((), dtype=torch.float64, device=x.device)
    gram = torch.zeros((x.shape[1],) * 2, dtype=torch.float64,
                       device=x.device)
    for i in range(0, x.shape[0], rows):
        c = x[i:i + rows].double()
        cs += c.sum(0)
        sq += (c * c).sum()
        gram += c.mT @ c
    return cs, sq, gram


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from petal_decomposition_tpu_torch import (
        RandomizedPca,
        RandomizedPcaBuilder,
    )
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_kernels as k2,
        sketch_kernel as k1,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    k1.build()
    k2.build()
    build_s = time.perf_counter() - t0
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "kernel_build_s": build_s})

    # -- K1 against its plain version, at the flagship shapes ----------
    x = make_data(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    w = torch.randn(D, L, generator=g, device=dev)
    y, cs, sq = k1.fused_sketch_moments(x, w)
    yp, _, _ = k1._sketch_moments_plain(x, w)
    cs64, sq64, gram64 = f64_moments(x)
    y_err = float((y - yp).abs().max())
    y_band = 1e-4 * float(yp.abs().max())
    cs_dev = float(((cs.double() - cs64).abs()
                    - (1e-4 * cs64.abs() + 1e-3)).max())
    sq_rel = abs(float(sq) - float(sq64)) / float(sq64)
    require(y_err <= y_band, f"K1 Y error {y_err} > {y_band}")
    require(cs_dev <= 0, "K1 colsum outside rtol 1e-4 / atol 1e-3 of f64")
    require(sq_rel <= 1e-5, f"K1 sqnorm relative error {sq_rel} > 1e-5")
    k1_ms = cuda_ms(lambda: k1.fused_sketch_moments(x, w), 20)
    k1_plain_ms = cuda_ms(lambda: k1._sketch_moments_plain(x, w), 20)
    del y, yp
    emit({"phase": "k1_vs_plain", "x": [N, D], "w": [D, L],
          "y_max_abs_err": y_err, "y_band": y_band,
          "sqnorm_rel_err": sq_rel, "ms": k1_ms, "plain_ms": k1_plain_ms})

    # -- the slice: RandomizedPca.fit through K1 and K2 ----------------
    def slice_model():
        return (RandomizedPcaBuilder(K).seed(SEED).range_finder("gram")
                .gram_projection("data").device("cuda").build())

    panels = []
    real_k2 = k2.jacobi_svd_vmem

    def capture(a, **kw):
        panels.append(a.clone())
        return real_k2(a, **kw)

    k2.jacobi_svd_vmem = capture
    try:
        slice_model().fit(x)  # warm-up; hands phase K2 the fit's panel
    finally:
        k2.jacobi_svd_vmem = real_k2
    require(len(panels) == 1, "the fit did not reach the Jacobi kernel")

    launches = {"sketch_moments": 0, "jacobi_svd": 0}
    fit_ms = []
    for _ in range(3):
        model = slice_model()
        k1.launches = 0
        k2.launches = 0
        model.fit(x)
        require(k1.launches > 0, "a slice fit launched no K1")
        require(k2.launches > 0, "a slice fit launched no K2")
        launches["sketch_moments"] += k1.launches
        launches["jacobi_svd"] += k2.launches
        fit_ms.append(model.last_fit_stats_.wall_time_s * 1e3)
    means = cs64 / N
    gc = gram64 - N * torch.outer(means, means)
    sigma_ref = torch.linalg.eigvalsh(gc).flip(0)[:K].clamp(min=0).sqrt()
    sigma = model.singular_values_.double()
    sig_rel = float(((sigma - sigma_ref).abs() / sigma_ref).max())
    require(sig_rel <= 1e-4, f"slice σ relative error {sig_rel} > 1e-4")
    z = model.transform(x)
    back = model.inverse_transform(z)
    require(tuple(z.shape) == (N, K) and bool(torch.isfinite(z).all()),
            "transform is not finite (N, K)")
    require(tuple(back.shape) == (N, D)
            and bool(torch.isfinite(back).all()),
            "inverse_transform is not finite (N, D)")
    z_ft = slice_model().fit_transform(x)
    ft_err = float((z_ft - z).abs().max() / z.abs().max())
    require(ft_err <= 1e-4, f"fit_transform vs fit+transform {ft_err}")
    emit({"phase": "slice", "route": "range_finder=gram, "
          "gram_projection=data", "fit_ms": fit_ms,
          "fit_ms_median": statistics.median(fit_ms),
          "launches_per_3_fits": launches, "sigma_rel_err_vs_f64": sig_rel,
          "fit_transform_rel_err": ft_err})
    del z, back, z_ft

    # -- K2 against its plain version and float64 singular values ------
    g.manual_seed(SEED + 2)
    cases = {
        "fit_panel": panels[0],
        "random_1024x44": torch.randn(1024, 44, generator=g, device=dev),
        "rank5_1024x44": torch.randn(1024, 5, generator=g, device=dev)
        @ torch.randn(5, 44, generator=g, device=dev),
    }
    k2_report = {}
    k2_err = 0.0
    for name, a in cases.items():
        m, n = a.shape
        a_rot, v, off = k2.jacobi_svd_vmem(a)
        a_rot_p, _, _ = k2._jacobi_svd_plain(a, 30)
        s = a_rot.norm(dim=0).sort(descending=True).values.double()
        s_p = a_rot_p.norm(dim=0).sort(descending=True).values.double()
        s_ref = torch.linalg.svdvals(a.double())
        a64 = a.double()
        rec = float((a_rot.double() @ v.double().mT - a64).norm()
                    / a64.norm())
        orth = float((v.double().mT @ v.double() - torch.eye(
            n, dtype=torch.float64, device=dev)).abs().max())
        sig = float((s - s_ref).abs().max() / s_ref[0])
        sig_plain = float((s - s_p).abs().max() / s_ref[0])
        tol = k2._tol(m, n)
        require(sig <= 1e-5, f"K2 {name}: σ error {sig} > 1e-5·σ₁")
        require(sig_plain <= 1e-5, f"K2 {name}: σ vs plain {sig_plain}")
        require(rec <= 1e-5, f"K2 {name}: reconstruction {rec} > 1e-5")
        require(orth <= 1e-5, f"K2 {name}: ‖VᵀV − I‖ {orth} > 1e-5")
        require(float(off) <= tol, f"K2 {name}: off {float(off)} > {tol}")
        k2_err = max(k2_err, float((s - s_p).abs().max()))
        k2_report[name] = {"shape": [m, n], "sigma_rel_err_f64": sig,
                           "sigma_rel_err_plain": sig_plain,
                           "reconstruction": rec, "orthogonality": orth,
                           "off": float(off), "tol": tol}
    panel = cases["fit_panel"]
    k2_ms = cuda_ms(lambda: k2.jacobi_svd_vmem(panel), 20)
    k2_plain_ms = cuda_ms(lambda: k2._jacobi_svd_plain(panel, 30), 3)
    emit({"phase": "k2_vs_plain", "cases": k2_report, "ms": k2_ms,
          "plain_ms": k2_plain_ms})

    # -- the default constructor: zero-pass route, no kernel -----------
    default_ms = []
    k1.launches = 0
    k2.launches = 0
    for _ in range(3):
        dm = RandomizedPca(K, seed=SEED, device="cuda").fit(x)
        default_ms.append(dm.last_fit_stats_.wall_time_s * 1e3)
    s_def = dm.singular_values_.double()
    require(bool(torch.isfinite(s_def).all()), "default fit σ not finite")
    def_rel = float(((s_def - sigma) / sigma).abs().max())
    require(def_rel <= 1e-4, f"default vs slice σ {def_rel} > 1e-4")
    emit({"phase": "default_route", "route": "zero-pass Gram recovery",
          "fit_ms": default_ms, "fit_ms_median": statistics.median(default_ms),
          "sigma_rel_vs_slice": def_rel,
          "launches": {"sketch_moments": k1.launches,
                       "jacobi_svd": k2.launches}})

    emit({"kernels": [
        {"name": "sketch_moments", "route": "cuda",
         "source": "petal_decomposition_tpu_torch/csrc/sketch_moments.cu",
         "replaces": "petal_decomposition_tpu/ops/pallas/sketch_kernel.py:143",
         "launches": launches["sketch_moments"], "max_abs_err": y_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "jacobi_svd", "route": "cuda",
         "source": "petal_decomposition_tpu_torch/csrc/jacobi_svd.cu",
         "replaces":
             "petal_decomposition_tpu/ops/pallas/jacobi_kernels.py:187",
         "launches": launches["jacobi_svd"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
