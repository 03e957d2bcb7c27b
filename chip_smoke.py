#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``petal_decomposition_tpu_torch/csrc``
(one ``nvcc`` per source, all at once), holds each against its plain
PyTorch version at the shapes of the main paths, and drives those paths
through the entry points a user calls:

* ``RandomizedPca.fit`` on an in-core 1,000,000 × 1024 float32 matrix,
  k = 32, through the route that runs K1 and K2, and through the
  default constructor;
* exact ``Pca`` on a 200,000 × 256 float64 feature table, k = 32,
  through QR + K3 on R and through the Gram solver with K3 as its
  eigensolver; BASELINE config 1 (1000 × 64 float64, direct K3); a
  1,000,000 × 64 float32 fit through QR + K2 on R; the 200,000 × 256
  table in float32 through the default solver (QR + K2 on the 256×256
  R) and through the Gram solver;
* ``RandomizedPca`` at BASELINE config 2 (100,000 × 1024 float64,
  k = 32, default knobs), whose SVD of Bᵀ is K3, and the same table
  through the zero-pass Gram recovery, whose two 42×42 eighs are K3.

K2 and K3 are then timed on the panels those fits hand them and a few
more (``K2_TIMED``, ``K3_TIMED``).  Each path is driven with the
kernels' launch counts set to 0 just before it and read just after.
Every phase prints one JSON line with its
numbers and its time; any failed check raises, so the exit code is
non-zero.  The line before the card's name holds each kernel's time,
its plain version's, one PyTorch call's for the same function where
there is one, and its bound: the larger of the bytes it must move over
3.35 TB/s and its operations over the peak rate of their type (NVIDIA's
H100 SXM data sheet): K1's split product at 989 TFLOP/s, bf16 on the
tensor cores, and its moments at 67 TFLOP/s, float32 outside them; the
Jacobi kernels' rotations (this run's sweeps of n(n−1)/2 column pairs
each, the fewer of the kernel's and the TPU kernel's order's) at
67 TFLOP/s, float32 outside the tensor cores or float64 on them.  The
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the package beside it, the script fails before printing any
result.
"""

from __future__ import annotations

import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

N, D, K, SEED = 1_000_000, 1024, 32, 20261016
L = K + 10  # the fit's sketch width (k + n_oversamples)
N64, D64 = 200_000, 256  # the exact float64 fit's feature table
NR, DR = 100_000, 1024  # BASELINE config 2, the float64 randomized fit
N32, D32 = 1_000_000, 64  # the exact float32 fit
N32W, D32W = 200_000, 256  # the exact float32 fit on the feature table
CUDA = "cuda"
HBM_BYTES_S = 3.35e12
# NVIDIA's H100 SXM data sheet: float32 outside the tensor cores, float64
# on them (DMMA; 34 outside them), bf16 on them (dense).
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12}


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


def make_data(dev, n=N, d=D, dtype=None, seed=SEED):
    """Low rank plus noise with a non-zero mean: σⱼ ∝ 3·0.9ʲ over 32
    directions above a flat noise floor; mean small enough that the
    fused centering needs no guard pass."""
    import torch

    dtype = dtype or torch.float32
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    basis = torch.linalg.qr(
        torch.randn(d, K, generator=g, device=dev, dtype=dtype)
    ).Q.T
    scale = 3.0 * 0.9 ** torch.arange(K, device=dev, dtype=dtype)
    x = 0.05 * torch.randn(n, d, generator=g, device=dev, dtype=dtype)
    x += (torch.randn(n, K, generator=g, device=dev, dtype=dtype)
          * scale) @ basis
    x += 0.1 * torch.randn(d, generator=g, device=dev, dtype=dtype)
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


def sigma_of_centered_gram(x, k=K):
    """Top-k σ of X − 1μᵀ from its float64 Gram."""
    import torch

    cs, _, gram = f64_moments(x)
    mu = cs / x.shape[0]
    gc = gram - x.shape[0] * torch.outer(mu, mu)
    return torch.linalg.eigvalsh(gc).flip(0)[:k].clamp(min=0).sqrt()


@contextlib.contextmanager
def capturing(module, name):
    """Record a copy of the panel each call of ``module.name`` gets."""
    real = getattr(module, name)
    seen = []

    def wrapper(a, **kw):
        seen.append(a.clone())
        return real(a, **kw)

    setattr(module, name, wrapper)
    try:
        yield seen
    finally:
        setattr(module, name, real)


# The Jacobi wrapper of each kernel module, by the module's name.
JACOBI_WRAPPERS = {"jacobi_kernels": "jacobi_svd_vmem",
                   "jacobi_f64_kernel": "jacobi_svd_vmem_f64"}


def rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max())


def bound(nbytes: float, flops: dict):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and the operations (type → count) over the peak rates of their
    types."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = sum(f / PEAK_FLOP_S[t] for t, f in flops.items()) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sweeps_to_converge(run, a, tol, max_sweeps=30) -> int:
    """The sweeps a Jacobi solver ``run(a, max_sweeps=s)`` runs on ``a``:
    the fewest whose certificate meets ``tol`` (it is deterministic, and
    stops at the first sweep that meets it), found by bisection."""
    lo, hi = 1, max_sweeps
    while lo < hi:
        mid = (lo + hi) // 2
        if float(run(a, max_sweeps=mid)[2]) <= tol:
            hi = mid
        else:
            lo = mid + 1
    return lo


def jacobi_bound(a, sweeps: int):
    """The least time for ``sweeps`` one-sided Jacobi sweeps of an m×n
    panel: read it, write U·σ and V; per sweep n(n−1)/2 column pairs,
    each three dot products and a rotation of its m rows of A and n
    rows of V."""
    m, n = a.shape
    size = a.element_size()
    flops = sweeps * n * (n - 1) / 2 * (12 * m + 6 * n)
    return bound(size * (2 * m * n + n * n), {str(a.dtype)[6:]: flops})


def pca64_data(dev):
    """The exact float64 fits' 200,000 × 256 feature table."""
    import torch

    return make_data(dev, N64, D64, torch.float64, SEED + 3)


def pca32_data(dev):
    """The exact float32 fit's 1,000,000 × 64 table."""
    import torch

    return make_data(dev, N32, D32, torch.float32, SEED + 5)


def pca32w_data(dev):
    """The 200,000 × 256 feature table in float32 (≈ 205 MB)."""
    import torch

    return make_data(dev, N32W, D32W, torch.float32, SEED + 9)


def r632_data(dev):
    """A 20,000 × 632 float32 table, whose exact fit hands K2 the widest
    R factor within its reach."""
    import torch

    return make_data(dev, 20_000, 632, torch.float32, SEED + 10)


def config1_data(dev):
    """BASELINE config 1's table: 1000 × 64 float64 Gaussian."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 4)
    return torch.randn(1000, 64, generator=g, device=dev,
                       dtype=torch.float64)


def randomized64_data(dev):
    """BASELINE config 2's table: 100,000 × 1024 float64."""
    import torch

    return make_data(dev, NR, DR, torch.float64, SEED + 6)


def split_panel(dev, dtype=None, rows=10_000):
    """A centered ``rows`` × 50 Gaussian panel (float64 by default) with
    column scales 1 to 5, as an exact fit of such a table hands it to
    the Jacobi kernel directly: K3's plan splits 10,000 × 50 over two
    block pairs and each pair's rows over 23 CTAs, K2's 20,000 × 50 the
    same way (a float32 thread holds twice the rows)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    dtype = dtype or torch.float64
    x = (torch.randn(rows, 50, generator=g, device=dev, dtype=dtype)
         * torch.linspace(1, 5, 50, device=dev, dtype=dtype))
    return x - x.mean(0)


def exact_model(api, dev, solver="full"):
    return api.PcaBuilder(K).solver(solver).device(dev).build()


def data_route_model(api, dev):
    """The float32 slice's route: the sketch through K1, Bᵀ through K2."""
    return (api.RandomizedPcaBuilder(K).seed(SEED).range_finder("gram")
            .gram_projection("data").device(dev).build())


def randomized_model(api, dev):
    """BASELINE config 2's model: the default knobs."""
    return api.RandomizedPca(K, seed=SEED, device=dev)


def gram_recovery_model(api, dev):
    """The zero-pass Gram-recovery fit in float64: two l×l eighs."""
    return (api.RandomizedPcaBuilder(K).seed(SEED).finder_precision("full")
            .range_finder("gram").gram_projection("gram").device(dev)
            .build())


def kernel_inputs(mod, make, x, count):
    """Fit ``make()`` on ``x`` once and return the ``count`` panels the
    fit handed the Jacobi kernel of ``mod`` (K2's or K3's module); any
    number where ``count`` is None."""
    name = JACOBI_WRAPPERS[mod.__name__.rsplit(".", 1)[1]]
    with capturing(mod, name) as seen:
        make().fit(x)
    require(count is None or len(seen) == count,
            f"a fit ran {name} {len(seen)} times, not {count}")
    return seen


def fit_panels(mod, fits, dev, on_fit=None, strict=True):
    """The first panel each fit of ``fits`` (panel name → (data, make,
    count)) hands the Jacobi kernel of ``mod``, one table on the card at
    a time; not ``strict``, a fit whose route runs no such kernel (an
    older tree's) hands none.  ``on_fit(name, make, x)`` is called after
    each capture."""
    panels, table = {}, {}
    for name, (data, make, count) in fits.items():
        if data not in table:
            table.clear()
            table[data] = data(dev)
        seen = kernel_inputs(mod, make, table[data], count if strict else None)
        if seen:
            panels[name] = seen[0]
        if on_fit is not None:
            on_fit(name, make, table[data])
    table.clear()
    return panels


def k3_panels(api, k3, dev, on_fit=None):
    """The panels K3 is timed on (``K3_TIMED``), from the fits that hand
    them over: the 256×256 R and Gram of exact ``Pca(32)`` on the
    200k×256 table (QR and Gram routes), Bᵀ 1024×42 of config 2's
    ``RandomizedPca`` and the first 42×42 eigh of its zero-pass Gram
    recovery, config 1's centered 1000×64 panel (direct K3) and
    ``split_panel``.  ``on_fit(name, make, x)`` is called after each
    fit's capture."""
    panels = fit_panels(k3, {
        "r_factor_256x256": (pca64_data, lambda: exact_model(api, dev), 1),
        "psd_gram_256x256": (
            pca64_data, lambda: exact_model(api, dev, "gram"), 1),
        "bt_1024x42": (
            randomized64_data, lambda: randomized_model(api, dev), 1),
        "gram_recovery_eigh_42x42": (
            randomized64_data, lambda: gram_recovery_model(api, dev), 2),
    }, dev, on_fit)
    x = config1_data(dev)
    panels["config1_centered_1000x64"] = x - x.mean(0)
    panels["split_10000x50"] = split_panel(dev)
    return panels


def k2_more_panels(api, k2, dev, on_fit=None, strict=True):
    """The panels K2 is timed on beside those the smoke run's main fits
    hand it: the 632×632 R of exact ``Pca(32)`` on a 20,000 × 632
    float32 table (QR + K2, the widest R within reach), config 1's
    centered table in float32 (1000×64, direct K2) and ``split_panel``
    in float32 at 20,000 rows (rows split over CTAs)."""
    import torch

    panels = fit_panels(k2, {
        "r_factor_632x632": (r632_data, lambda: exact_model(api, dev), 1),
    }, dev, on_fit, strict)
    x = config1_data(dev).float()
    panels["config1_f32_1000x64"] = x - x.mean(0)
    panels["split_20000x50"] = split_panel(dev, torch.float32, 20_000)
    return panels


def k2_panels(api, k2, dev, on_fit=None, strict=True):
    """The panels K2 is timed on (``K2_TIMED``), from the fits that hand
    them over: Bᵀ 1024×43 of the data-route ``RandomizedPca`` on the
    1M×1024 table, the 64×64 R of exact ``Pca(32)`` on the 1M×64 float32
    table, the 256×256 R of exact ``Pca(32)`` on the 200k×256 float32
    table (default solver), and :func:`k2_more_panels`.  ``strict``: as
    :func:`fit_panels`."""
    panels = fit_panels(k2, {
        "bt_1024x43": (make_data, lambda: data_route_model(api, dev), 1),
        "r_factor_64x64": (pca32_data, lambda: exact_model(api, dev), 1),
        "r_factor_256x256": (
            pca32w_data, lambda: exact_model(api, dev, "auto"), 1),
    }, dev, on_fit, strict)
    panels.update(k2_more_panels(api, k2, dev, on_fit, strict))
    return panels


def timed_fits(make, x, kernels, reps=3):
    """Fit ``make()`` on ``x`` ``reps`` times, each with every count in
    ``kernels`` (name → module) set to 0 just before and read just
    after: ``(fit ms list, launch totals, the last model)``."""
    fit_ms, totals = [], {name: 0 for name in kernels}
    for _ in range(reps):
        model = make()
        for mod in kernels.values():
            mod.launches = 0
        model.fit(x)
        for name, mod in kernels.items():
            require(mod.launches > 0, f"a fit launched no {name}")
            totals[name] += mod.launches
        fit_ms.append(model.last_fit_stats_.wall_time_s * 1e3)
    return fit_ms, totals, model


def check_jacobi(name, a, run, plain, tol, sig_band, rec_band, orth_band):
    """A Jacobi kernel's factors of ``a`` against float64 ``svdvals``
    and against its plain version: ``(report, max |Δσ| vs plain)``."""
    import torch

    m, n = a.shape
    a_rot, v, off = run(a)
    a_rot_p, _, _ = plain(a)
    s = a_rot.norm(dim=0).sort(descending=True).values.double()
    s_p = a_rot_p.norm(dim=0).sort(descending=True).values.double()
    a64 = a.double()
    s_ref = torch.linalg.svdvals(a64)
    rec = float((a_rot.double() @ v.double().mT - a64).norm() / a64.norm())
    orth = float((v.double().mT @ v.double() - torch.eye(
        n, dtype=torch.float64, device=a.device)).abs().max())
    sig = float((s - s_ref).abs().max() / s_ref[0])
    sig_plain = float((s - s_p).abs().max() / s_ref[0])
    require(sig <= sig_band, f"{name}: σ error {sig} > {sig_band}·σ₁")
    require(sig_plain <= sig_band, f"{name}: σ vs plain {sig_plain}")
    require(rec <= rec_band, f"{name}: reconstruction {rec} > {rec_band}")
    require(orth <= orth_band, f"{name}: ‖VᵀV − I‖ {orth} > {orth_band}")
    require(float(off) <= tol, f"{name}: off {float(off)} > {tol}")
    report = {"shape": [m, n], "sigma_rel_err_f64": sig,
              "sigma_rel_err_plain": sig_plain, "reconstruction": rec,
              "orthogonality": orth, "off": float(off), "tol": tol}
    return report, float((s - s_p).abs().max())


def qr_route_stages(x, kernel):
    """Device ms of an exact fit's stages on the QR route: centering,
    Householder QR, the Jacobi kernel on R, and Q·R_rot."""
    import torch

    xc = x - x.mean(0)
    q, r = torch.linalg.qr(xc)
    r_rot, _, _ = kernel(r)
    return {
        "center": cuda_ms(lambda: x - x.mean(0), 5),
        "qr": cuda_ms(lambda: torch.linalg.qr(xc), 5),
        "kernel_on_r": cuda_ms(lambda: kernel(r), 5),
        "q_times_r_rot": cuda_ms(lambda: q @ r_rot, 5),
    }


def phase(fn):
    """Run a phase and print its JSON line with the phase's seconds."""
    def run(ctx):
        t0 = time.perf_counter()
        out = fn(ctx)
        out["phase_s"] = time.perf_counter() - t0
        emit(out)
    return run


# -- the in-core float32 RandomizedPca slice: K1 and K2 ----------------

@phase
def phase_k1(ctx):
    """K1 against its plain version, at the flagship shapes."""
    import torch

    k1, dev = ctx.k1, ctx.dev
    ctx.x = x = make_data(dev)
    ctx.g = g = torch.Generator(device=dev)
    g.manual_seed(SEED + 1)
    w = torch.randn(D, L, generator=g, device=dev)
    y, cs, sq = k1.fused_sketch_moments(x, w)
    yp, _, _ = k1._sketch_moments_plain(x, w)
    cs64, sq64, ctx.gram64 = f64_moments(x)
    ctx.cs64 = cs64
    y_err = float((y - yp).abs().max())
    y_band = 1e-4 * float(yp.abs().max())
    cs_dev = float(((cs.double() - cs64).abs()
                    - (1e-4 * cs64.abs() + 1e-3)).max())
    sq_rel = abs(float(sq) - float(sq64)) / float(sq64)
    require(y_err <= y_band, f"K1 Y error {y_err} > {y_band}")
    require(cs_dev <= 0, "K1 colsum outside rtol 1e-4 / atol 1e-3 of f64")
    require(sq_rel <= 1e-5, f"K1 sqnorm relative error {sq_rel} > 1e-5")
    ms = cuda_ms(lambda: k1.fused_sketch_moments(x, w), 20)
    plain_ms = cuda_ms(lambda: k1._sketch_moments_plain(x, w), 20)
    # No one PyTorch call computes Y, the column sums and ‖X‖²_F; the
    # product alone is timed beside it.
    matmul_ms = cuda_ms(lambda: x @ w, 20)
    # Three bf16 products on the tensor cores; the sums and squares in
    # float32 outside them.
    bound_ms, bound_by = bound(4 * (N * D + D * L + N * L + D + 1),
                               {"bfloat16": 3 * 2 * N * D * L,
                                "float32": 3 * N * D})
    ctx.kernels["sketch_moments"].update(
        max_abs_err=y_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None,
    )
    return {"phase": "k1_vs_plain", "x": [N, D], "w": [D, L],
            "y_max_abs_err": y_err, "y_band": y_band,
            "sqnorm_rel_err": sq_rel, "ms": ms, "plain_ms": plain_ms,
            "x_times_w_ms": matmul_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "share_of_bound": bound_ms / ms,
            "ms_over_x_times_w": ms / matmul_ms}


@phase
def phase_slice(ctx):
    """The slice: RandomizedPca.fit through K1 and K2."""
    import torch

    k1, k2, x = ctx.k1, ctx.k2, ctx.x

    def slice_model():
        return data_route_model(ctx.api, CUDA)

    # The warm-up hands phase K2 the fit's panel.
    (ctx.k2_cases["bt_1024x43"],) = kernel_inputs(k2, slice_model, x, 1)
    fit_ms, launches, model = timed_fits(
        slice_model, x, {"sketch_moments": k1, "jacobi_svd": k2}
    )
    ctx.add_launches(launches)
    means = ctx.cs64 / N
    gc = ctx.gram64 - N * torch.outer(means, means)
    sigma_ref = torch.linalg.eigvalsh(gc).flip(0)[:K].clamp(min=0).sqrt()
    ctx.slice_sigma = sigma = model.singular_values_.double()
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
    return {"phase": "slice", "route": "range_finder=gram, "
            "gram_projection=data", "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms),
            "launches_per_3_fits": launches,
            "sigma_rel_err_vs_f64": sig_rel, "fit_transform_rel_err": ft_err}


@phase
def phase_default(ctx):
    """The default constructor: zero-pass route, no kernel."""
    import torch

    k1, k2 = ctx.k1, ctx.k2
    default_ms = []
    k1.launches = 0
    k2.launches = 0
    for _ in range(3):
        dm = ctx.api.RandomizedPca(K, seed=SEED, device=CUDA).fit(ctx.x)
        default_ms.append(dm.last_fit_stats_.wall_time_s * 1e3)
    s_def = dm.singular_values_.double()
    require(bool(torch.isfinite(s_def).all()), "default fit σ not finite")
    sigma = ctx.slice_sigma
    def_rel = float(((s_def - sigma) / sigma).abs().max())
    require(def_rel <= 1e-4, f"default vs slice σ {def_rel} > 1e-4")
    del ctx.x
    torch.cuda.empty_cache()
    return {"phase": "default_route", "route": "zero-pass Gram recovery",
            "fit_ms": default_ms,
            "fit_ms_median": statistics.median(default_ms),
            "sigma_rel_vs_slice": def_rel,
            "launches": {"sketch_moments": k1.launches,
                         "jacobi_svd": k2.launches}}


# -- exact Pca, and the float64 paths through K3 ----------------------


@phase
def phase_pca_f64(ctx):
    """Exact Pca, float64, 200k × 256: QR + K3 on the 256×256 R."""
    import torch

    k3, linalg = ctx.k3, ctx.linalg
    ctx.x64 = x64 = pca64_data(ctx.dev)

    def make():
        return exact_model(ctx.api, CUDA)

    (r_panel,) = kernel_inputs(k3, make, x64, 1)  # warm-up; hands phase K3 its R
    require(tuple(r_panel.shape) == (D64, D64),
            "the exact f64 fit did not run K3 on the 256×256 R")
    ctx.k3_cases["r_factor_256x256"] = r_panel
    fit_ms, launches, model = timed_fits(make, x64, {"jacobi_svd_f64": k3})
    ctx.add_launches(launches)
    xc = x64 - x64.mean(0)
    ctx.s_ref64 = s_ref = torch.linalg.svdvals(xc)
    sig = float((model._singular_full - s_ref).abs().max() / s_ref[0])
    require(sig <= 1e-10, f"exact f64 σ error {sig} > 1e-10·σ₁")
    z = model.transform(x64)
    ft = rel_max(exact_model(ctx.api, CUDA).fit_transform(x64), z)
    require(ft <= 1e-10, f"exact f64 fit_transform vs transform {ft}")
    back = model.inverse_transform(z)
    require(back.shape == x64.shape and bool(torch.isfinite(back).all()),
            "exact f64 inverse_transform is not finite (N, D)")
    evr_sum = float(model.explained_variance_ratio_.sum())
    require(evr_sum <= 1 + 1e-12, f"explained variance sums to {evr_sum}")

    def plain_pipeline():
        xcp = x64 - x64.mean(0)
        u, s, vt = torch.linalg.svd(xcp, full_matrices=False)
        return (*linalg.svd_flip(u, vt), s)

    # The QR + K3 composition against cuSOLVER's SVD, signs fixed by
    # svd_flip on both sides.
    u_ref, vt_ref, s_ref = plain_pipeline()
    comp = float((model.components_ - vt_ref[:K]).abs().max())
    tr = rel_max(z, u_ref[:, :K] * s_ref[:K])
    del u_ref
    require(comp <= 1e-10, f"exact f64 components vs cuSOLVER {comp}")
    require(tr <= 1e-10, f"exact f64 transform vs cuSOLVER U·σ {tr}")
    plain_ms = cuda_ms(plain_pipeline, 3)
    stages = qr_route_stages(x64, k3.jacobi_svd_vmem_f64)
    return {"phase": "pca_f64", "x": [N64, D64], "k": K,
            "route": "QR + K3 on R", "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms),
            "plain_pipeline_ms": plain_ms, "stages_ms": stages,
            "launches_per_3_fits": launches,
            "sigma_rel_err_vs_svdvals": sig, "fit_transform_rel_err": ft,
            "components_max_abs_err_vs_svd": comp,
            "transform_rel_err_vs_svd": tr,
            "explained_variance_ratio_sum": evr_sum}


@phase
def phase_pca_f64_gram(ctx):
    """The same table through the Gram solver: K3 as the eigensolver."""
    import torch

    k3, x64 = ctx.k3, ctx.x64

    def make():
        return exact_model(ctx.api, CUDA, "gram")

    (psd,) = kernel_inputs(k3, make, x64, 1)  # warm-up
    require(tuple(psd.shape) == (D64, D64),
            "the Gram fit did not run K3 on the 256×256 Gram")
    ctx.k3_cases["psd_gram_256x256"] = psd
    fit_ms, launches, model = timed_fits(make, x64, {"jacobi_svd_f64": k3})
    ctx.add_launches(launches)
    s_ref = ctx.s_ref64
    sig = float((model._singular_full - s_ref).abs().max() / s_ref[0])
    require(sig <= 1e-8, f"Gram-route σ error {sig} > 1e-8·σ₁")
    eigh_k3_ms = cuda_ms(lambda: ctx.linalg.eigh_psd_jit_cert(psd), 5)
    eigh_torch_ms = cuda_ms(lambda: torch.linalg.eigh(psd), 5)
    del ctx.x64
    torch.cuda.empty_cache()
    return {"phase": "pca_f64_gram", "x": [N64, D64], "k": K,
            "route": "Gram + K3 eigh", "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms),
            "launches_per_3_fits": launches,
            "sigma_rel_err_vs_svdvals": sig,
            "eigh_256_k3_ms": eigh_k3_ms, "eigh_256_torch_ms": eigh_torch_ms}


@phase
def phase_config1(ctx):
    """BASELINE config 1: 1000 × 64 float64 Gaussian, direct K3, against
    the reference pipeline (center → SVD → svd_flip → U·σ) in float64
    by cuSOLVER."""
    import torch

    k3, linalg = ctx.k3, ctx.linalg
    x = config1_data(ctx.dev)
    model = ctx.api.PcaBuilder(64).device(CUDA).build()
    k3.launches = 0
    y = model.fit_transform(x)
    launches = {"jacobi_svd_f64": k3.launches}
    require(k3.launches > 0, "config 1 fit launched no K3")
    ctx.add_launches(launches)
    mu = x.mean(0)
    ctx.k3_cases["config1_centered_1000x64"] = x - mu
    u, s, vt = torch.linalg.svd(x - mu, full_matrices=False)
    u, vt = linalg.svd_flip(u, vt)
    y_ref = u * s
    err = float((y - y_ref).abs().max())
    t_err = float((model.transform(x) - y_ref).abs().max())
    inv_err = float((model.inverse_transform(y) - (y_ref @ vt + mu))
                    .abs().max())
    require(err <= 1e-10, f"config 1 fit_transform error {err}")
    require(t_err <= 1e-10, f"config 1 transform error {t_err}")
    require(inv_err <= 1e-10, f"config 1 inverse_transform error {inv_err}")
    return {"phase": "pca_config1", "x": [1000, 64], "k": 64,
            "route": "direct K3",
            "fit_transform_ms": model.last_fit_stats_.wall_time_s * 1e3,
            "launches": launches, "fit_transform_max_abs_err": err,
            "transform_max_abs_err": t_err,
            "inverse_transform_max_abs_err": inv_err}


@phase
def phase_pca_f32(ctx):
    """Exact Pca, float32, 1M × 64: QR + K2 on the 64×64 R."""
    import torch

    k2 = ctx.k2
    x = pca32_data(ctx.dev)

    def make():
        return exact_model(ctx.api, CUDA)

    (r_panel,) = kernel_inputs(k2, make, x, 1)  # warm-up; hands phase K2 R
    require(tuple(r_panel.shape) == (D32, D32),
            "the exact f32 fit did not run K2 on the 64×64 R")
    ctx.k2_cases["r_factor_64x64"] = r_panel
    fit_ms, launches, model = timed_fits(make, x, {"jacobi_svd": k2})
    ctx.add_launches(launches)
    x64 = x.double()
    s_ref = torch.linalg.svdvals(x64 - x64.mean(0))[:K]
    sig = float(((model.singular_values_.double() - s_ref).abs()
                 / s_ref).max())
    require(sig <= 1e-5, f"exact f32 σ relative error {sig} > 1e-5")
    stages = qr_route_stages(x, k2.jacobi_svd_vmem)
    del x, x64
    torch.cuda.empty_cache()
    return {"phase": "pca_f32", "x": [N32, D32], "k": K,
            "route": "QR + K2 on R", "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms), "stages_ms": stages,
            "launches_per_3_fits": launches, "sigma_rel_err_vs_f64": sig}


@phase
def phase_pca_f32_wide(ctx):
    """Exact Pca, float32, 200k × 256 on the default solver: QR + K2 on
    the 256×256 R (the JAX package's route, now that K2 reaches a 632×632
    R), once a fit; beside it the Gram solver, whose σ square through
    XᵀX.  σ against float64: the QR route within 1e-5, the Gram route's
    error recorded."""
    import torch

    k2 = ctx.k2
    x = pca32w_data(ctx.dev)

    def make():
        return exact_model(ctx.api, CUDA, "auto")

    def make_gram():
        return exact_model(ctx.api, CUDA, "gram")

    (r_panel,) = kernel_inputs(k2, make, x, 1)  # warm-up; hands phase K2 R
    require(tuple(r_panel.shape) == (D32W, D32W),
            "the f32 auto fit did not run K2 on the 256×256 R")
    ctx.k2_cases["r_factor_256x256"] = r_panel
    fit_ms, launches, model = timed_fits(make, x, {"jacobi_svd": k2})
    require(launches["jacobi_svd"] == 3, "K2 not once per fit")
    ctx.add_launches(launches)
    x64 = x.double()
    s_ref = torch.linalg.svdvals(x64 - x64.mean(0))[:K]
    del x64

    def sigma_err(fitted):
        s = fitted.singular_values_.double()
        return float(((s - s_ref).abs() / s_ref).max())

    sig = sigma_err(model)
    require(sig <= 1e-5, f"exact f32 QR + K2 σ relative error {sig} > 1e-5")
    make_gram().fit(x)  # warm-up
    gram_ms, _, gram_model = timed_fits(make_gram, x, {})
    sig_gram = sigma_err(gram_model)
    require(math.isfinite(sig_gram), "Gram-route σ is not finite")
    stages = qr_route_stages(x, k2.jacobi_svd_vmem)
    del x
    torch.cuda.empty_cache()
    return {"phase": "pca_f32_wide", "x": [N32W, D32W], "k": K,
            "route": "QR + K2 on R (solver auto)", "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms), "stages_ms": stages,
            "launches_per_3_fits": launches, "sigma_rel_err_vs_f64": sig,
            "gram_fit_ms": gram_ms,
            "gram_fit_ms_median": statistics.median(gram_ms),
            "gram_sigma_rel_err_vs_f64": sig_gram}


@phase
def phase_randomized_f64(ctx):
    """BASELINE config 2: RandomizedPca on 100k × 1024 float64 at the
    default knobs; its SVD of Bᵀ is K3, once per fit."""
    import torch

    k3 = ctx.k3
    ctx.xr = x = randomized64_data(ctx.dev)

    def model():
        return randomized_model(ctx.api, CUDA)

    (bt,) = kernel_inputs(k3, model, x, 1)  # warm-up; hands phase K3 its Bᵀ
    require(tuple(bt.shape) == (DR, L),
            "the f64 randomized fit did not run K3 on Bᵀ")
    ctx.k3_cases["bt_1024x42"] = bt
    fit_ms, launches, fitted = timed_fits(model, x, {"jacobi_svd_f64": k3})
    require(launches["jacobi_svd_f64"] == 3, "K3 not once per fit")
    ctx.add_launches(launches)
    ctx.sigma_r = s_ref = sigma_of_centered_gram(x)
    sig = float(((fitted.singular_values_ - s_ref).abs() / s_ref).max())
    require(sig <= 1e-4, f"f64 randomized σ relative error {sig} > 1e-4")
    return {"phase": "randomized_f64", "x": [NR, DR], "k": K,
            "route": "mixed finder, data-side recovery, K3 on Bᵀ",
            "fit_ms": fit_ms, "fit_ms_median": statistics.median(fit_ms),
            "launches_per_3_fits": launches, "sigma_rel_err_vs_f64": sig}


@phase
def phase_gram_recovery_f64(ctx):
    """The same table through the zero-pass Gram recovery in float64:
    its two 42×42 PSD eighs are K3, twice per fit."""
    import torch

    k3, x = ctx.k3, ctx.xr
    panels = kernel_inputs(k3, lambda: gram_recovery_model(ctx.api, CUDA), x, 2)
    require(all(tuple(p.shape) == (L, L) for p in panels),
            "the Gram-recovery fit did not run K3 on its two l×l eighs")
    ctx.k3_cases["gram_recovery_eigh_42x42"] = panels[0]
    fit_ms, launches, fitted = timed_fits(
        lambda: gram_recovery_model(ctx.api, CUDA), x, {"jacobi_svd_f64": k3}
    )
    require(launches["jacobi_svd_f64"] == 6, "K3 not twice per fit")
    ctx.add_launches(launches)
    s_ref = ctx.sigma_r
    sig = float(((fitted.singular_values_ - s_ref).abs() / s_ref).max())
    require(sig <= 1e-4, f"Gram-recovery σ relative error {sig} > 1e-4")
    del ctx.xr
    torch.cuda.empty_cache()
    return {"phase": "gram_recovery_f64", "x": [NR, DR], "k": K,
            "route": "f64 finder, zero-pass Gram recovery, K3 eighs",
            "fit_ms": fit_ms, "fit_ms_median": statistics.median(fit_ms),
            "launches_per_3_fits": launches, "sigma_rel_err_vs_f64": sig}


# The panels K2 is timed on; the PyTorch call for each is the SVD.
K2_TIMED = ("bt_1024x43", "r_factor_64x64", "config1_f32_1000x64",
            "r_factor_256x256", "r_factor_632x632", "split_20000x50")


def vector_band(n: int) -> float:
    """K2's band for V's orthogonality and the reconstruction: 1e-5 up to
    64 columns, then growing as √n, since the rounding of the ≈ n·sweeps
    rotations each column of V sees adds up as a random walk."""
    return 1e-5 * max(1.0, (n / 64) ** 0.5)


@phase
def phase_k2(ctx):
    """K2 against its block plain version and float64 singular values,
    on the panels the fits handed it, ``k2_more_panels`` and two of
    1024×44; the time of each panel of ``K2_TIMED`` beside its plain
    version, cuSOLVER's ``gesvd`` and its bound (at the fewer sweeps of
    the kernel's and the TPU kernel's order's)."""
    import torch

    k2, g, dev = ctx.k2, ctx.g, ctx.dev
    g.manual_seed(SEED + 2)
    cases = dict(ctx.k2_cases, **k2_more_panels(ctx.api, k2, dev))
    cases["random_1024x44"] = torch.randn(1024, 44, generator=g, device=dev)
    cases["rank5_1024x44"] = (
        torch.randn(1024, 5, generator=g, device=dev)
        @ torch.randn(5, 44, generator=g, device=dev))

    def block_plain(p):
        return k2._jacobi_svd_block_plain(p, 30, k2.plan(*p.shape)[0])

    def tpu_order(p, max_sweeps):
        return k2._jacobi_svd_plain(p, max_sweeps)

    report, err_max = {}, 0.0
    for name, a in cases.items():
        band = vector_band(a.shape[1])
        report[name], err = check_jacobi(
            f"K2 {name}", a, k2.jacobi_svd_vmem, block_plain,
            k2._tol(*a.shape), 1e-5, band, band,
        )
        err_max = max(err_max, err)
    times = {}
    for name in K2_TIMED:
        a = cases[name]
        tol = k2._tol(*a.shape)
        sweeps = sweeps_to_converge(k2.jacobi_svd_vmem, a, tol)
        sweeps_tpu = sweeps_to_converge(tpu_order, a, tol)
        bound_ms, bound_by = jacobi_bound(a, min(sweeps, sweeps_tpu))
        times[name] = {
            "shape": list(a.shape),
            "plan_w_P_R": list(k2.plan(*a.shape)[:3]),
            "ms": cuda_ms(lambda: k2.jacobi_svd_vmem(a), 20),
            "plain_ms": cuda_ms(lambda: block_plain(a), 1),
            "library_ms": cuda_ms(lambda: torch.linalg.svd(
                a, full_matrices=False, driver="gesvd"), 20),
            "library": "torch.linalg.svd gesvd",
            "sweeps": sweeps, "sweeps_tpu_order": sweeps_tpu,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    ctx.kernels["jacobi_svd"].update(
        max_abs_err=err_max,
        **{key: times["bt_1024x43"][key]
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "bound_by")},
    )
    return {"phase": "k2_vs_plain", "cases": report, "times": times}


# The panels K3 is timed on, and the one PyTorch call for each: eigh on
# the PSD matrices (as the eigh route uses them), the SVD elsewhere.
K3_TIMED = {
    "r_factor_256x256": "svd",
    "psd_gram_256x256": "eigh",
    "gram_recovery_eigh_42x42": "eigh",
    "config1_centered_1000x64": "svd",
    "bt_1024x42": "svd",
    "split_10000x50": "svd",
}


@phase
def phase_k3(ctx):
    """K3 against its block plain version and float64 singular values,
    on the panels the fits handed it, ``split_panel`` and a rank-5 one; the time of each
    panel beside its plain version, one PyTorch call and its bound (at
    the fewer sweeps of the kernel's and the TPU kernel's order's)."""
    import torch

    k3, g = ctx.k3, ctx.g
    g.manual_seed(SEED + 7)
    f64 = torch.float64
    cases = dict(ctx.k3_cases, split_10000x50=split_panel(ctx.dev))
    cases["rank5_1000x64"] = (
        torch.randn(1000, 5, generator=g, device=ctx.dev, dtype=f64)
        @ torch.randn(5, 64, generator=g, device=ctx.dev, dtype=f64)
    )

    def block_plain(p):
        return k3._jacobi_svd_block_plain_f64(p, 30, k3.plan(*p.shape)[0])

    def tpu_order(p, max_sweeps):
        return k3._jacobi_svd_plain_f64(p, max_sweeps)

    report, err_max = {}, 0.0
    for name, a in cases.items():
        report[name], err = check_jacobi(
            f"K3 {name}", a, k3.jacobi_svd_vmem_f64, block_plain,
            k3._tol(*a.shape), 1e-11, 1e-11, 1e-12,
        )
        err_max = max(err_max, err)
    times = {}
    for name, call in K3_TIMED.items():
        a = cases[name]
        library = (functools.partial(torch.linalg.eigh, a) if call == "eigh"
                   else functools.partial(torch.linalg.svd, a,
                                          full_matrices=False,
                                          driver="gesvd"))
        tol = k3._tol(*a.shape)
        sweeps = sweeps_to_converge(k3.jacobi_svd_vmem_f64, a, tol)
        sweeps_tpu = sweeps_to_converge(tpu_order, a, tol)
        bound_ms, bound_by = jacobi_bound(a, min(sweeps, sweeps_tpu))
        times[name] = {
            "plan_w_P_R": list(k3.plan(*a.shape)[:3]),
            "ms": cuda_ms(lambda: k3.jacobi_svd_vmem_f64(a), 20),
            "plain_ms": cuda_ms(lambda: block_plain(a), 1),
            "library_ms": cuda_ms(library, 20),
            "library": f"torch.linalg.{call}",
            "sweeps": sweeps, "sweeps_tpu_order": sweeps_tpu,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    ctx.kernels["jacobi_svd_f64"].update(
        max_abs_err=err_max,
        **{key: times["r_factor_256x256"][key]
           for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                       "bound_by")},
    )
    return {"phase": "k3_vs_plain", "cases": report, "times": times}


PHASES = (phase_k1, phase_slice, phase_default, phase_pca_f64,
          phase_pca_f64_gram, phase_config1, phase_pca_f32,
          phase_pca_f32_wide, phase_randomized_f64, phase_gram_recovery_f64,
          phase_k2, phase_k3)

KERNELS = {
    "sketch_moments": ("sketch_moments.cu", "sketch_kernel.py:143"),
    "jacobi_svd": ("jacobi_svd.cu", "jacobi_kernels.py:187"),
    "jacobi_svd_f64": ("jacobi_svd_f64.cu", "jacobi_f64_kernel.py:187"),
}


def context():
    """Import the port, build its kernels in parallel and print the
    device line; the state the phases share."""
    import torch

    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops import linalg
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel as k3,
        jacobi_kernels as k2,
        sketch_kernel as k1,
    )

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        for done in [pool.submit(m.build) for m in (k1, k2, k3)]:
            done.result()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": time.perf_counter() - t0})
    ctx = SimpleNamespace(
        api=api, linalg=linalg, k1=k1, k2=k2, k3=k3, smi=smi,
        dev=torch.device(CUDA), k2_cases={}, k3_cases={},
        kernels={name: {"launches": 0} for name in KERNELS},
    )

    def add_launches(counts):
        for name, n in counts.items():
            ctx.kernels[name]["launches"] += n

    ctx.add_launches = add_launches
    return ctx


def kernels_line(ctx) -> dict:
    out = []
    for name, (source, replaces) in KERNELS.items():
        k = ctx.kernels[name]
        out.append({
            "name": name, "route": "cuda",
            "source": f"petal_decomposition_tpu_torch/csrc/{source}",
            "replaces": f"petal_decomposition_tpu/ops/pallas/{replaces}",
            "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ctx = context()
    for run in PHASES:
        run(ctx)
    emit(kernels_line(ctx))
    print(ctx.smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
