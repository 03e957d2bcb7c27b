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
  through the zero-pass Gram recovery, whose two 42×42 eighs are K3;
* the single-device surface: ``RandomizedPca(32)`` on complex data
  (config 2's shape in complex128, the flagship's in complex64), which
  runs no kernel; ``save``/``load`` on the card of four fitted models,
  transforms and next fits bitwise; config 1 through the host C++ core,
  through the tiny-fit offload and through K3, timed; the flagship data
  route and config 1 inside ``nan_debugging()``, bitwise, and a NaN out
  of each kernel raising with its wrapper's name;
* ``FastIca`` at BASELINE config 3 (100,000 samples of 64 Laplace
  sources, float64 and float32) at the card's defaults and each
  alternative of its three autos: float64 whitens through K3's 64×64
  eigh and decorrelates through it, float32 whitens through QR + K2 on
  the 64×64 R; with the parts of one step timed, the recovered sources
  checked and 30-iteration fits at three seeds held against the same fits
  on the CPU;
* the streamed fits from host blocks: ``RandomizedPca(32).fit_batched``
  on the north-star stream (16 blocks of 65536 × 4096 float32, 16 GiB;
  with its feed's parts, the card's busy share and the in-core fit of
  the same matrix), exact ``Pca(32).fit_batched`` on it and on the
  200,000 × 256 float64 table (K3 on the 256² Gram), BASELINE config 2
  streamed (K3 on the Gram recovery's two 42×42 eighs), ``partial_fit``
  one block a call against ``fit_batched``, and config 3 streamed
  through ``FastIca.fit_batched`` (K3 whitens in float64);
* the row-sharded fits (``parallel``): the flagship's K1 route through a
  one-rank NCCL group (``mesh_one_card``); several shards of the one
  card (``mesh_shards``: the flagship's route on 1,000,003 rows over
  four shards, the last padded, with K1 on every shard held against its
  plain version; exact float64 ``Pca`` over three shards through K3;
  config 3's ``FastIca`` over two; BASELINE config 4's width, 1M × 4096
  float32, over four); and two processes of this script on the card in
  a gloo group, two shards each (``multihost``: the flagship and config 3
  in core, the north-star stream split 8 / 8, lockstep ``partial_fit``,
  replicated state bitwise equal on both), each fit held against the
  same fit without a mesh.

K4, FastICA's fused step update (``csrc/ica_update.cu``), is held
against the eager update on config-3 steps at k = 64 and at its largest
k, and timed beside it (``k4``); the config-3 fits count its launches.
K5, the float32-grade Gram (``csrc/gram_syrk.cu``), is held to the IEEE
float32 matmul's grade against float64 Grams, across n from its row floor
up and on the mean-cancellation guard's fused path, held against its
plain version, and timed beside both (``k5``); the in-core north-star fit
and the north-star stream count its launches.

K2's σ is checked at the edges of its reach (the JAX kernel's gate), and
past the gate QR + K2 on R is timed beside K2 on the panel itself
(``k2_reach``).  K2 and K3 are then timed on the panels those fits hand
them and a few
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
or without the package beside it, the script exits with code 2 and a
message, before printing any result.
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
NI, KI = 100_000, 64  # BASELINE config 3: FastIca, 64 sources × 100k samples
CUDA = "cuda"
HBM_BYTES_S = 3.35e12
# NVIDIA's H100 SXM data sheet: float32 outside the tensor cores, float64
# on them (DMMA; 34 outside them), bf16 and TF32 on them (dense).
PEAK_FLOP_S = {"float32": 67e12, "float64": 67e12, "bfloat16": 989e12,
               "tf32": 495e12}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def device_ms(fn, reps: int, lead_ms: float = 20.0) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events
    behind a ``lead_ms`` spin of the card, so the host has queued all of
    ``fn`` before the card reaches it: the card's time alone, not the
    host's time to issue it (which :func:`cuda_ms` counts when the card
    waits on the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    cycles = int(lead_ms * 2e6)  # at most 2 GHz: at least lead_ms
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


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


def ica_sources(dev, seed=SEED + 11):
    """BASELINE config 3's sources and mixing: S, 100,000 × 64 Laplace(0,
    1) draws, and A = Q₁·diag(1 … 4)·Q₂ᵀ with Q₁, Q₂ random orthogonal,
    so κ(A) = 4; float64."""
    import torch

    f64 = torch.float64
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    e = torch.empty((2, NI, KI), dtype=f64, device=dev).exponential_(
        generator=g)
    q1, q2 = (torch.linalg.qr(torch.randn(KI, KI, generator=g, device=dev,
                                          dtype=f64)).Q for _ in range(2))
    a = (q1 * torch.linspace(1, 4, KI, device=dev, dtype=f64)) @ q2.mT
    return e[0] - e[1], a


def ica64_data(dev):
    """BASELINE config 3's table X = S·Aᵀ in float64 (51 MB)."""
    s, a = ica_sources(dev)
    return s @ a.mT


def ica32_data(dev):
    """The same table in float32 (26 MB)."""
    return ica64_data(dev).float()


def amari_distance(p) -> float:
    """How far the k×k ``p`` is from a scaled permutation: Amari's index
    over 2k(k − 1), 0 for a scaled permutation and at most 1."""
    r = p.abs()
    k = r.shape[0]
    rows = (r.sum(1) / r.amax(1) - 1).sum()
    cols = (r.sum(0) / r.amax(0) - 1).sum()
    return float((rows + cols) / (2 * k * (k - 1)))


@contextlib.contextmanager
def card_rungs_on_cpu():
    """Run CPU fits through the rungs the card takes: every float64 PSD
    eigh within K3's reach by ``linalg._eigh_psd_k3`` and every SVD by
    its CUDA rung, each kernel's wrapper running its plain version on a
    CPU tensor.  The eigen- and singular vectors' signs are then the
    kernels' own, so a CPU fit whitens as the card's does."""
    from petal_decomposition_tpu_torch import config
    from petal_decomposition_tpu_torch.ops import jacobi, linalg
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel as k3,
    )

    real_eigh, real_route = linalg.eigh_psd_jit_cert, jacobi._route
    backend = config.linalg_backend

    def eigh(a):
        if not a.is_cuda and k3.supports(a.shape[0], a.shape[0], a.dtype):
            return linalg._eigh_psd_k3(a)
        return real_eigh(a)

    linalg.eigh_psd_jit_cert = eigh
    jacobi._route = lambda m, n, dtype, _device_type: real_route(
        m, n, dtype, "cuda")
    config.linalg_backend = "jacobi"
    try:
        yield
    finally:
        linalg.eigh_psd_jit_cert, jacobi._route = real_eigh, real_route
        config.linalg_backend = backend


def split_panel(dev):
    """A centered 10,000 × 50 float64 Gaussian panel with column scales
    1 to 5, as an exact fit of such a table hands it to K3 directly:
    K3's plan splits it over two block pairs and each pair's rows over
    23 CTAs."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 8)
    f64 = torch.float64
    x = (torch.randn(10_000, 50, generator=g, device=dev, dtype=f64)
         * torch.linspace(1, 5, 50, device=dev, dtype=f64))
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


def ica_model(api, dev, seed=SEED, **knobs):
    """BASELINE config 3's model: FastIca at the defaults and ``knobs``."""
    return api.FastIca(seed=seed, device=dev, **knobs)


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
    recovery, config 3's 64×64 whitening Gram (``FastIca``'s first of
    three K3 eighs; a tree without ``FastIca`` hands none), config 1's
    centered 1000×64 panel (direct K3) and ``split_panel``.
    ``on_fit(name, make, x)`` is called after each fit's capture."""
    fits = {
        "r_factor_256x256": (pca64_data, lambda: exact_model(api, dev), 1),
        "psd_gram_256x256": (
            pca64_data, lambda: exact_model(api, dev, "gram"), 1),
        "bt_1024x42": (
            randomized64_data, lambda: randomized_model(api, dev), 1),
        "gram_recovery_eigh_42x42": (
            randomized64_data, lambda: gram_recovery_model(api, dev), 2),
    }
    if hasattr(api, "FastIca"):
        fits["fast_ica_gram_64x64"] = (
            ica64_data, lambda: ica_model(api, dev), 3)
    panels = fit_panels(k3, fits, dev, on_fit)
    x = config1_data(dev)
    panels["config1_centered_1000x64"] = x - x.mean(0)
    panels["split_10000x50"] = split_panel(dev)
    return panels


def k2_more_panels(api, k2, dev, on_fit=None, strict=True):
    """The panels K2 is timed on beside those the smoke run's main fits
    hand it: the 632×632 R of exact ``Pca(32)`` on a 20,000 × 632
    float32 table (QR + K2, the widest R within reach) and config 1's
    centered table in float32 (1000×64, direct K2)."""
    panels = fit_panels(k2, {
        "r_factor_632x632": (r632_data, lambda: exact_model(api, dev), 1),
    }, dev, on_fit, strict)
    x = config1_data(dev).float()
    panels["config1_f32_1000x64"] = x - x.mean(0)
    return panels


def k2_panels(api, k2, dev, on_fit=None, strict=True):
    """The panels K2 is timed on (``K2_TIMED``), from the fits that hand
    them over: Bᵀ 1024×43 of the data-route ``RandomizedPca`` on the
    1M×1024 table, the 64×64 R of exact ``Pca(32)`` on the 1M×64 float32
    table, the 256×256 R of exact ``Pca(32)`` on the 200k×256 float32
    table (default solver), the 64×64 R of config 3's float32
    ``FastIca`` whitening (a tree without ``FastIca`` hands none), and
    :func:`k2_more_panels`.  ``strict``: as :func:`fit_panels`."""
    fits = {
        "bt_1024x43": (make_data, lambda: data_route_model(api, dev), 1),
        "r_factor_64x64": (pca32_data, lambda: exact_model(api, dev), 1),
        "r_factor_256x256": (
            pca32w_data, lambda: exact_model(api, dev, "auto"), 1),
    }
    if hasattr(api, "FastIca"):
        fits["fast_ica_r_factor_64x64"] = (
            ica32_data, lambda: ica_model(api, dev), 1)
    panels = fit_panels(k2, fits, dev, on_fit, strict)
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
    """Run a phase and print its JSON line with the phase's seconds and
    what it added to each kernel's main-path launch count."""
    def run(ctx):
        before = {n: k["launches"] for n, k in ctx.kernels.items()}
        t0 = time.perf_counter()
        out = fn(ctx)
        out["phase_s"] = time.perf_counter() - t0
        out["launches_added"] = {n: k["launches"] - before[n]
                                 for n, k in ctx.kernels.items()}
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
    ctx.slice_components = model.components_
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
    """The default constructor: zero-pass route, no kernel; its Gram on
    the IEEE matmul, as d = 1024 is below K5's ``MIN_D``."""
    import torch

    k1, k2 = ctx.k1, ctx.k2
    default_ms = []
    k1.launches = 0
    k2.launches = 0
    for _ in range(3):
        dm = ctx.api.RandomizedPca(K, seed=SEED, device=CUDA).fit(ctx.x)
        default_ms.append(dm.last_fit_stats_.wall_time_s * 1e3)
    extra = dm.last_fit_stats_.extra
    grams = {"matmul": extra["gram_matmul_calls"],
             "gram_syrk": extra["gram_kernel_calls"]}
    require(grams == {"matmul": 1, "gram_syrk": 0},
            f"default fit's Grams {grams}, not one on the matmul")
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
            "sigma_rel_vs_slice": def_rel, "grams_per_fit": grams,
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


# -- FastIca at BASELINE config 3: K3 and K2 --------------------------

# The fits: the card's defaults (decorrelation "ns"; for float64 also
# iteration_precision "f32" and whiten_solver "eigh") and each
# alternative of those three autos, with full precision and the eigh
# decorrelation together, the one float64 setting whose every step runs
# K3.
ICA_FITS = {
    "f64_defaults": ("float64", {}),
    "f64_decorrelation_eigh": ("float64", {"decorrelation": "eigh"}),
    "f64_precision_full": ("float64", {"iteration_precision": "full"}),
    "f64_precision_full_decorrelation_eigh": (
        "float64", {"iteration_precision": "full", "decorrelation": "eigh"}),
    "f64_whiten_svd": ("float64", {"whiten_solver": "svd"}),
    "f32_defaults": ("float32", {}),
    "f32_decorrelation_eigh": ("float32", {"decorrelation": "eigh"}),
    "f32_whiten_eigh": ("float32", {"whiten_solver": "eigh"}),
}

# Amari distance of components·A from a scaled permutation that a
# config-3 fit must stay under: the port's CPU fits of this table (float64
# full precision with eigh, float64 "f32" stages with ns, float32; 200
# iterations each) all read 0.00279.  The index averages over k², so a
# fit must also recover every source one to one: the rows' largest
# entries of |components·A| fall in distinct columns, each at least
# SOURCE_RATIO_MIN times its row's next (78 in the CPU float32 fit).
AMARI_MAX = 0.005
SOURCE_RATIO_MIN = 10.0


def sources_recovered(p) -> float:
    """The smallest ratio of a row's largest to its next entry of |p|,
    after requiring the rows' largest entries in distinct columns."""
    r = p.abs()
    require(len(set(r.argmax(1).tolist())) == r.shape[0],
            "two components unmix the same source")
    top2 = r.topk(2, dim=1).values
    return float((top2[:, 0] / top2[:, 1]).min())


def ica_step_split(fi, linalg, x1, reps=20):
    """Device ms (CUDA events, median of ``reps``) of the parts of one
    FastIca step at a fixed W on the whitened k×n ``x1``: W·X, the
    logcosh contrast, G·Xᵀ, the sums as the step takes them (K6 in
    float32), each decorrelation, whole steps, and, by the
    host clock over ``reps`` steps, the cost of reading ``lim`` on the
    host every step."""
    import torch

    k, n = x1.shape
    g = torch.Generator(device=x1.device)
    g.manual_seed(SEED + 12)
    w = fi.symmetric_decorrelation(torch.randn(
        k, k, generator=g, device=x1.device, dtype=x1.dtype))
    wx = linalg.mdot(w, x1)
    gwtx, gsum = fi._contrast_sums("logcosh", wx)
    upd = linalg.mdot(gwtx, x1.mT) / n - (gsum / n)[:, None] * w
    ns, eigh = fi.symmetric_decorrelation_ns, fi.symmetric_decorrelation
    out = {
        "w_times_x": cuda_ms(lambda: linalg.mdot(w, x1), reps),
        "contrast": cuda_ms(lambda: fi._contrast_sums("logcosh", wx), reps),
        "g_times_xt": cuda_ms(lambda: linalg.mdot(gwtx, x1.mT), reps),
        "sums": cuda_ms(lambda: fi._block_sums(w, x1, "logcosh"), reps),
        "decorrelation_ns": cuda_ms(lambda: ns(upd), reps),
        "decorrelation_eigh": cuda_ms(lambda: eigh(upd), reps),
        "step_ns": cuda_ms(lambda: fi._step(w, x1, "logcosh", ns, 1 / n),
                           reps),
        "step_eigh": cuda_ms(
            lambda: fi._step(w, x1, "logcosh", eigh, 1 / n), reps),
    }
    if x1.dtype == torch.float64:
        from petal_decomposition_tpu_torch import config
        from petal_decomposition_tpu_torch.ops import splitmm

        backend, config.linalg_backend = config.linalg_backend, "torch"
        try:
            out["decorrelation_eigh_torch"] = cuda_ms(lambda: eigh(upd), reps)
        finally:
            config.linalg_backend = backend
        x32, w32 = x1.float(), w.float()
        out["step_ns_f32_stage"] = cuda_ms(
            lambda: fi._step(w32, x32, "logcosh", ns, 1 / n), reps)
        xh, xl = splitmm.split_f64(x1)
        out["step_ns_ds64_stage"] = cuda_ms(
            lambda: fi._step_ds(w, xh, xl, "logcosh", ns, 1 / n), reps)

    def host_loop(read):
        ww = w
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            ww, lim = fi._step(ww, x1, "logcosh", ns, 1 / n)
            if read:
                float(lim)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps

    host_loop(True)  # warm-up
    out["step_ns_host_ms_reading_lim"] = with_read = host_loop(True)
    out["step_ns_host_ms_not_reading"] = without = host_loop(False)
    out["lim_read_ms"] = with_read - without
    return out


@phase
def phase_fast_ica_config3(ctx):
    """BASELINE config 3: FastIca on 100,000 samples of 64 Laplace
    sources mixed by A (κ = 4), float64 and float32, at the card's
    defaults and each alternative of the three autos (``ICA_FITS``): fit
    ms (median of 3), n_iter, iters/s, the whitening's ms, each fit's K2
    and K3 launches, its decorrelation certificate and the Amari
    distance of components·A, with every source recovered one to one;
    and the parts of one step."""
    import torch

    from petal_decomposition_tpu_torch.models import fast_ica as fi

    api, k2, k3, linalg = ctx.api, ctx.k2, ctx.k3, ctx.linalg
    s, a = ica_sources(ctx.dev)
    xs = {"float64": s @ a.mT}
    del s
    xs["float32"] = xs["float64"].float()
    kernels = {"jacobi_svd": k2, "jacobi_svd_f64": k3, "ica_update": ctx.k4,
               "ica_sums": ctx.k6}

    # The panels the fits hand K2 and K3 (the warm-up fits).
    ctx.k3_cases["fast_ica_gram_64x64"] = kernel_inputs(
        k3, lambda: ica_model(api, CUDA), xs["float64"], 3)[0]
    ctx.k3_cases["fast_ica_decorrelation_64x64"] = kernel_inputs(
        k3, lambda: ica_model(api, CUDA, iteration_precision="full",
                              decorrelation="eigh"),
        xs["float64"], None)[2]
    (ctx.k2_cases["fast_ica_r_factor_64x64"],) = kernel_inputs(
        k2, lambda: ica_model(api, CUDA), xs["float32"], 1)
    require(tuple(ctx.k2_cases["fast_ica_r_factor_64x64"].shape) == (KI, KI)
            and tuple(ctx.k3_cases["fast_ica_gram_64x64"].shape) == (KI, KI),
            "FastIca did not whiten through K3's Gram eigh (float64) and "
            "QR + K2 on the 64×64 R (float32)")

    fits = {}
    for dtype, x in xs.items():
        xc = x - x.mean(0)
        xc64 = xc.double()
        gram = xc64.mT @ xc64
        for name, (dt, knobs) in ICA_FITS.items():
            if dt != dtype:
                continue
            ica_model(api, CUDA, **knobs).fit(x)  # warm-up
            fit_ms, counts, iters = [], [], []
            for _ in range(3):
                model = ica_model(api, CUDA, **knobs)
                for mod in kernels.values():
                    mod.launches = 0
                model.fit(x)
                counts.append({n: m.launches for n, m in kernels.items()})
                iters.append(model.n_iter_)
                fit_ms.append(model.last_fit_stats_.wall_time_s * 1e3)
            solver = fi.resolve_whiten_solver(
                knobs.get("whiten_solver", "auto"), x.dtype, "cuda")
            need = ["jacobi_svd_f64"] if dtype == "float64" else (
                ["jacobi_svd"] if solver == "svd" else [])
            # A float32 step under Newton–Schulz is one K4 launch.
            k4_every_step = dtype == "float32" and fi.resolve_decorrelation(
                knobs.get("decorrelation", "auto"), "cuda") == "ns"
            for c, it in zip(counts, iters):
                for kname in need:
                    require(c[kname] > 0, f"FastIca {name} launched no {kname}")
                require(not k4_every_step or c["ica_update"] == it,
                        f"FastIca {name}: {c['ica_update']} K4 launches in "
                        f"{it} steps")
                # A float32 step's sums are one K6 launch.
                require(dtype != "float32" or c["ica_sums"] == it,
                        f"FastIca {name}: {c['ica_sums']} K6 launches in "
                        f"{it} steps")
                ctx.add_launches(c)
            comp = model.components_.double()
            g = comp @ gram @ comp.mT
            cert = float((g @ g - g).abs().max())
            fi.check_decorrelation_value(cert, x.dtype)
            amari = amari_distance(comp @ a)
            require(amari <= AMARI_MAX,
                    f"FastIca {name}: Amari distance {amari} > {AMARI_MAX}")
            ratio = sources_recovered(comp @ a)
            require(ratio >= SOURCE_RATIO_MIN,
                    f"FastIca {name}: a source's ratio {ratio}")
            med = statistics.median(fit_ms)
            fits[name] = {
                "knobs": knobs, "whiten_solver": solver, "fit_ms": fit_ms,
                "fit_ms_median": med, "n_iter": model.n_iter_,
                "iters_per_s": model.n_iter_ / (med / 1e3),
                "whitening_ms": cuda_ms(
                    lambda: fi._whitening_matrix(xc.mT, KI, solver), 5),
                "launches_per_fit": counts,
                "decorrelation_certificate": cert, "amari_distance": amari,
                "min_source_ratio": ratio,
            }
        del gram, xc64

    # The parts of one step, on each dtype's whitened table.
    split = {}
    for dtype, x in xs.items():
        xc = x - x.mean(0)
        kmat = fi._whitening_matrix(xc.mT, KI, "svd")[0]
        split[dtype] = ica_step_split(
            fi, linalg, linalg.mdot(kmat, xc.mT) * math.sqrt(NI))

    del xs
    torch.cuda.empty_cache()
    return {"phase": "fast_ica_config3", "x": [NI, KI], "fits": fits,
            "step_split_ms": split, "amari_max": AMARI_MAX,
            "source_ratio_min": SOURCE_RATIO_MIN}


def ica_card_and_cpu(api, x, seed=SEED, **kw):
    """Fit ``FastIca(seed=seed, **kw)`` on ``x`` on the card and on the
    CPU through the card's rungs (:func:`card_rungs_on_cpu`), both at the
    card's resolution of every auto, from one W₀: the seed's draw (the
    port draws on a CPU generator), decorrelated once in float64.  A
    random W₀'s own decorrelation is ill-conditioned in float32: the
    smallest eigenvalue of W₀·W₀ᵀ may lie within rounding of the
    pseudo-inverse cutoff (λmax·eps·k), where the two devices can decide
    apart and start O(1) apart.  Each whitened row's sign is the
    solver's own, and the card's kernels and their plain versions may
    choose a row's sign apart (a float32 QR + K2 did, on one of 64
    rows); so the CPU fit's W₀ has the columns of the flipped rows
    flipped too, which runs the same updates in the flipped coordinates
    and ends at the same components.  Returns ``(card, cpu,
    whitening_rel_err, rows_flipped)``."""
    import torch

    from petal_decomposition_tpu_torch.models import fast_ica as fi
    from petal_decomposition_tpu_torch.utils import rng

    solver = fi.resolve_whiten_solver(kw.get("whiten_solver", "auto"),
                                      x.dtype, "cuda")
    kw = dict(kw, whiten_solver=solver,
              decorrelation=fi.resolve_decorrelation(
                  kw.get("decorrelation", "auto"), "cuda"),
              iteration_precision=fi.resolve_iteration_precision(
                  kw.get("iteration_precision", "auto"), x.dtype, "cuda"))
    real_normal = rng.normal

    def w0(gen, shape, dtype, device):
        w = real_normal(gen, shape, dtype, "cpu").double()
        lam, v = torch.linalg.eigh(w @ w.mT)
        return ((v * lam.rsqrt()) @ v.mT @ w).to(device, dtype)

    xh = x.cpu()
    k = min(x.shape)
    k_card = fi._whitening_matrix((x - x.mean(0)).mT, k, solver)[0].cpu()
    rng.normal = w0
    try:
        card = ica_model(api, CUDA, seed, **kw).fit(x)
        with card_rungs_on_cpu():
            k_cpu = fi._whitening_matrix((xh - xh.mean(0)).mT, k, solver)[0]
            signs = torch.sign((k_card * k_cpu).sum(1))
            rng.normal = lambda *args: w0(*args) * signs
            cpu = ica_model(api, "cpu", seed, **kw).fit(xh)
    finally:
        rng.normal = real_normal
    k_err = rel_max(k_card.double(), (signs[:, None] * k_cpu).double())
    return card, cpu, k_err, int((signs < 0).sum())


def w0_lambda_ratio(seed, x) -> float:
    """λmin/λmax of W₀·W₀ᵀ for the W₀ ``FastIca(seed=seed)`` draws for
    ``x``: where it lies near the decorrelation's cutoff, eps·k, a fit's
    first decorrelation is a close call."""
    import torch

    from petal_decomposition_tpu_torch.utils import rng

    w = rng.normal(rng.split(rng.generator_from_seed(seed)), (KI, KI),
                   x.dtype, "cpu").double()
    lam = torch.linalg.eigvalsh(w @ w.mT)
    return float(lam[0] / lam[-1])


# The card-against-CPU fits: three seeds of config 3's data and W₀, at a
# fixed count past the map's sensitive first steps.
ICA_CHECK_SEEDS = (SEED + 11, SEED + 21, SEED + 31)
ICA_CHECK_ITERS = 30


@phase
def phase_fast_ica_card_vs_cpu(ctx):
    """Config 3's float64 fit (full precision, eigh: K3 whitens and
    decorrelates every step) and float32 fit (defaults: QR + K2
    whitens) on the card at tol = 0 and ``ICA_CHECK_ITERS`` iterations,
    against the port's own CPU fit (:func:`ica_card_and_cpu`), rows
    compared sign-canonically, for each seed of ``ICA_CHECK_SEEDS``; and
    the two whitening matrices, row signs aligned.  Bands: components
    1e-9 (float64) and 1e-4 (float32); whitening 1e-10 and 1e-4 (a
    Householder QR of 100,000 rows in float32 is exact to ≈ eps·√m ≈
    4e-5).  The map's first ≈ 10 steps amplify a perturbation of the
    whitening by up to 1e4 in float64 and to O(1) in float32; by step
    20 it has contracted it back to its own size
    (``tools/ica_sensitivity.py``), so 30 iterations compare the two
    devices' rounding and not where the map stood when it was read."""
    import torch

    checks = {}
    for seed in ICA_CHECK_SEEDS:
        s, a = ica_sources(ctx.dev, seed)
        x64 = s @ a.mT
        del s
        for x, knobs, k_band, band in (
                (x64, {"decorrelation": "eigh", "iteration_precision": "full"},
                 1e-10, 1e-9),
                (x64.float(), {}, 1e-4, 1e-4)):
            card, cpu, k_err, flipped = ica_card_and_cpu(
                ctx.api, x, seed, tol=0.0, max_iter=ICA_CHECK_ITERS, **knobs)
            want = cpu.components_.double()
            got = card.components_.double().cpu()
            got = got * torch.sign((got * want).sum(1, keepdim=True))
            checks[f"{str(x.dtype)[6:]}_seed{seed - SEED}"] = {
                "knobs": knobs, "w0_lambda_ratio": w0_lambda_ratio(seed, x),
                "decorrelation_cutoff": torch.finfo(x.dtype).eps * KI,
                "whitening_rel_err": k_err,
                "whitening_rows_flipped": flipped, "whitening_band": k_band,
                "components_rel_err": rel_max(got, want), "band": band,
                "n_iter": [card.n_iter_, cpu.n_iter_]}
    emit({"phase": "fast_ica_card_vs_cpu_numbers", "checks": checks})
    for name, c in checks.items():
        require(c["n_iter"] == [ICA_CHECK_ITERS] * 2,
                f"FastIca {name}: n_iter {c['n_iter']}")
        require(c["whitening_rel_err"] <= c["whitening_band"],
                f"FastIca {name}: whitening card vs CPU "
                f"{c['whitening_rel_err']}")
        require(c["components_rel_err"] <= c["band"],
                f"FastIca {name}: card vs CPU {c['components_rel_err']}")
    return {"phase": "fast_ica_card_vs_cpu", "checks": checks}


def ns_eager(m):
    """``symmetric_decorrelation_ns`` under another name: ``_update``
    runs its eager arithmetic for it, not K4."""
    from petal_decomposition_tpu_torch.models import fast_ica as fi

    return fi.symmetric_decorrelation_ns(m)


def ica_step_state(dev, k, seed, steps=3):
    """``(w, x1)`` of a float32 FastIca step at width ``k``: X₁ config
    3's whitened table at k = 64 (``ica32_data``), else ``k`` whitened
    Laplace sources of ``NI`` samples (κ(A) = 4 as config 3); W from a
    decorrelated Gaussian W₀ after ``steps`` eager steps."""
    import torch

    from petal_decomposition_tpu_torch.models import fast_ica as fi
    from petal_decomposition_tpu_torch.ops.linalg import mdot

    if k == KI:
        x = ica32_data(dev)
    else:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        e = torch.empty((2, NI, k), device=dev).exponential_(generator=g)
        q, _ = torch.linalg.qr(torch.randn(k, k, generator=g, device=dev))
        x = (e[0] - e[1]) @ (q * torch.linspace(1, 4, k, device=dev)).mT
    xc = x - x.mean(0)
    kmat = fi._whitening_matrix(xc.mT, k, "svd")[0]
    x1 = mdot(kmat, xc.mT) * math.sqrt(NI)
    g = torch.Generator().manual_seed(seed)
    w = fi.symmetric_decorrelation(torch.randn(k, k, generator=g).to(x1))

    for _ in range(steps):
        w, _ = fi._step(w, x1, "logcosh", ns_eager, 1.0 / NI)
    return w, x1


def k4_step(dev, k, seed, steps=3):
    """``(w, gx, gsum, p_inv)`` of the step :func:`ica_step_state`
    reaches, its sums the host loop's without K6."""
    from petal_decomposition_tpu_torch.ops.kernels import ica_sums

    w, x1 = ica_step_state(dev, k, seed, steps)
    return (w, *ica_sums._ica_sums_plain(w, x1, "logcosh"), 1.0 / NI)


# K4's check band: W1 and lim against the eager update (the test file's,
# tests/test_torch_ica_update_kernel.py; lim relative to 1).
K4_BAND = 1e-5


@phase
def phase_k4(ctx):
    """K4 against the eager update (``_update`` with
    ``symmetric_decorrelation_ns``, the kernel's plain arithmetic on the
    card) on config-3 steps at k = 64 and at ``K_MAX``: the largest
    relative difference of W1 and of lim; each one's device time (CUDA
    events behind a spin of the card, median of 20: the card's time
    alone) and its time as the loop sees it (CUDA events, median of 20:
    the host's issue time where the card waits); and K4's bound, 148·k³
    float32 operations at 67 TFLOP/s against 12·k² bytes at 3.35 TB/s."""
    import torch

    from petal_decomposition_tpu_torch.models import fast_ica as fi
    from petal_decomposition_tpu_torch.ops.kernels import ica_update as k4

    times, err_max = {}, 0.0
    for k in (KI, k4.K_MAX):
        w, gx, gsum, p_inv = k4_step(ctx.dev, k, SEED + 40 + k)
        w1, lim = k4.ica_update(w, gx, gsum, p_inv)
        e_w1, e_lim = fi._update(w, gx, gsum, ns_eager, p_inv, 0.0)
        torch.cuda.synchronize()
        w1_err = rel_max(w1.double(), e_w1.double())
        lim_err = abs(float(lim) - float(e_lim)) / max(1.0, float(e_lim))
        require(w1_err < K4_BAND and lim_err < K4_BAND,
                f"K4 at k = {k}: W1 {w1_err}, lim {lim_err} from the eager "
                "update")
        err_max = max(err_max, w1_err, lim_err)
        bound_ms, bound_by = bound(12 * k * k, {"float32": 148 * k ** 3})
        times[f"k{k}"] = {
            "k": k, "w1_rel_err": w1_err, "lim_err": lim_err,
            "lim": float(lim),
            "ms": device_ms(lambda: k4.ica_update(w, gx, gsum, p_inv), 20),
            "plain_ms": device_ms(
                lambda: fi._update(w, gx, gsum, ns_eager, p_inv, 0.0), 20),
            "issue_ms": cuda_ms(lambda: k4.ica_update(w, gx, gsum, p_inv),
                                20),
            "plain_issue_ms": cuda_ms(
                lambda: fi._update(w, gx, gsum, ns_eager, p_inv, 0.0), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
    ctx.kernels["ica_update"].update(
        max_abs_err=err_max, library_ms=None,
        **{key: times[f"k{KI}"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return {"phase": "k4_vs_eager", "band": K4_BAND, "times": times}


# K6's check band: gx and gsum against the host loop's sums on the card,
# the largest entry difference over the largest entry (K6's 3×TF32
# products and the IEEE matmuls, each ≈ 1e-6 from float64).
K6_BAND = 1e-5


def k6_grade(w, x1, fun, k6):
    """K6's sums and the host loop's IEEE-float32 sums against the float64
    sums of the same float32 operands: the largest entry error over the
    largest entry, for gx and for gsum."""
    from petal_decomposition_tpu_torch.models import fast_ica as fi

    wd, xd = w.double(), x1.double()
    g, ref_gsum = fi._contrast_sums(fun, wd @ xd)
    ref_gx = g @ xd.mT
    out = {}
    for name, (gx, gsum) in (("k6", k6.ica_sums(w, x1, fun)),
                             ("ieee", k6._ica_sums_plain(w, x1, fun))):
        out[name] = {"gx": rel_max(gx.double(), ref_gx),
                     "gsum": rel_max(gsum.double(), ref_gsum)}
    return out


@phase
def phase_k6(ctx):
    """K6 against its plain version (the host loop's seven-launch sums:
    two IEEE-float32 matmuls, the contrast, the g′ row sums) on config-3
    steps at k = 64 and at ``K_MAX``: the largest relative difference of
    gx and of gsum, and the same bits on a second call; K6's and the IEEE
    sums' grade against float64 sums of the same operands (three
    contrasts at k = 64); the device time of each (CUDA events behind a
    spin of the card, median of 20), their time as the loop sees them
    (CUDA events, median of 20), and K6's bound, 4·k²·n float32
    operations at 67 TFLOP/s against X₁'s bytes at 3.35 TB/s.  Then one
    float32 config-3 fit: K6 launches ``n_iter_`` times and the fit's
    stats count them."""
    import torch

    k6 = ctx.k6
    times, err_max = {}, 0.0
    for k in (KI, k6.K_MAX):
        w, x1 = ica_step_state(ctx.dev, k, SEED + 60 + k)
        gx, gsum = k6.ica_sums(w, x1, "logcosh")
        again = k6.ica_sums(w, x1, "logcosh")
        p_gx, p_gsum = k6._ica_sums_plain(w, x1, "logcosh")
        torch.cuda.synchronize()
        gx_err = rel_max(gx.double(), p_gx.double())
        gsum_err = rel_max(gsum.double(), p_gsum.double())
        require(gx_err < K6_BAND and gsum_err < K6_BAND,
                f"K6 at k = {k}: gx {gx_err}, gsum {gsum_err} from the "
                "plain sums")
        require(torch.equal(gx, again[0]) and torch.equal(gsum, again[1]),
                f"K6 at k = {k}: a second call gave other bits")
        err_max = max(err_max, gx_err, gsum_err)
        grade = {fun: k6_grade(w, x1, fun, k6)
                 for fun in (k6.CONTRASTS if k == KI else ("logcosh",))}
        n = x1.shape[1]
        bound_ms, bound_by = bound(4 * (k * n + 2 * k * k + k),
                                   {"float32": 4 * k * k * n})
        times[f"k{k}"] = {
            "k": k, "n": n, "gx_rel_err": gx_err, "gsum_rel_err": gsum_err,
            "grade_vs_float64": grade,
            "ms": device_ms(lambda: k6.ica_sums(w, x1, "logcosh"), 20),
            "plain_ms": device_ms(
                lambda: k6._ica_sums_plain(w, x1, "logcosh"), 20),
            "issue_ms": cuda_ms(lambda: k6.ica_sums(w, x1, "logcosh"), 20),
            "plain_issue_ms": cuda_ms(
                lambda: k6._ica_sums_plain(w, x1, "logcosh"), 20),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del w, x1
    before = k6.launches
    model = ctx.api.FastIca(seed=SEED, device=CUDA).fit(ica32_data(ctx.dev))
    fit_launches = k6.launches - before
    require(fit_launches == model.n_iter_
            and model.last_fit_stats_.extra["ica_sums_kernel_calls"]
            == model.n_iter_,
            f"K6: {fit_launches} launches in a {model.n_iter_}-step fit")
    ctx.add_launches({"ica_sums": fit_launches})
    ctx.kernels["ica_sums"].update(
        max_abs_err=err_max,
        library_ms=times[f"k{KI}"]["plain_ms"],
        **{key: times[f"k{KI}"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by")})
    return {"phase": "k6_vs_plain", "band": K6_BAND, "times": times,
            "fit": {"n_iter": model.n_iter_, "launches": fit_launches,
                    "fit_ms": model.last_fit_stats_.wall_time_s * 1e3}}


# K5's shapes: the in-core cell's X and one stream chunk, at the north
# star's width.
K5_ROWS = (1 << 20, 1 << 16)
K5_D = 4096
# K5 against its plain version at 65,536 × 4096, largest entry error over
# the largest entry: 1.08e-6 on an H100.
K5_PLAIN_BAND = 3e-6


def adversarial_data(dev, n, d=K5_D, seed=SEED + 52):
    """``benchmarks/GRAM_GRADE.json``'s spectrum: column scales
    log-spaced 30 → 0.03 over the first 64 columns, then 0.03 (κ ≈ 1e3),
    and column means 300·sin(0.37·j), ten times the largest scale."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    head = torch.logspace(math.log10(30.0), math.log10(0.03), 64)
    scales = torch.cat([head, torch.full((d - 64,), 0.03)]).to(dev)
    means = 300.0 * torch.sin(torch.arange(d, device=dev) * 0.37)
    x = torch.randn(n, d, generator=g, device=dev)
    return x.mul_(scales).add_(means)


def gram_errors(g, ref) -> dict:
    """``g`` against the float64 Gram ``ref``: the relative Frobenius
    error and the largest entry error over the largest entry."""
    diff = g.double() - ref
    return {"fro": float(diff.norm() / ref.norm()),
            "max": float(diff.abs().max() / ref.abs().max())}


def shifted_data(dev, n, d, seed):
    """Gaussian columns with scales log-spaced 1 → 0.01, shifted by 0.3:
    the small columns mean-dominated."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn(n, d, generator=g, device=dev)
    return x.mul_(torch.logspace(0, -2, d, device=dev)).add_(0.3)


def k5_grade_row(ctx, x, ref):
    """K5's and the IEEE matmul's errors against ``ref`` and the larger
    of K5's two readings over the matmul's."""
    with ctx.linalg.ieee_f32():
        lib = gram_errors(x.mT @ x, ref)
    got = gram_errors(ctx.k5.gram_syrk(x), ref)
    return {"k5": got, "ieee_matmul": lib,
            "ratio": max(got["fro"] / lib["fro"], got["max"] / lib["max"])}


def top_sigma_error(gram, mu, n, ref_sigma, k=K):
    """The largest error of the top-k σ of a centered float32 Gram
    (``gram`` − n·μμᵀ, its eigenvalues in float64) over σ₁ of
    ``ref_sigma``."""
    import torch

    gc = gram.double() - n * torch.outer(mu, mu)
    s = torch.linalg.eigvalsh(gc).flip(0)[:k].clamp(min=0).sqrt()
    return float((s - ref_sigma).abs().max() / ref_sigma[0])


@phase
def phase_k5(ctx):
    """K5's grade: its Gram and the IEEE matmul's (``xc.mT @ xc``, the
    library yardstick) against the float64 Gram of the same X, raw and
    centered, on the in-core cell's X (1M × 4096), one stream chunk
    (65,536 × 4096) and the adversarial spectrum; each K5 reading at most
    1.1 times the matmul's.  The same across n (16,384 to 262,144) and d
    (1536 to 4096) on three kinds of X, held from ``MIN_ROWS`` rows and
    ``MIN_D`` columns; the fused centering at ``MIN_ROWS`` with the
    mean-cancellation ratio just below the guard's ``"default"`` and
    ``"high"`` thresholds; the top σ of the in-core X's centered Gram
    from K5's and the matmul's Gram.  K5 against its plain version at
    65,536 × 4096.  Device ms of K5, its plain version and the matmul at
    both shapes (CUDA events behind a spin, medians), and K5's bound:
    n·d·(d + 1) operations at the TF32 peak against X's bytes; and the
    two at 262,144 rows for d from 512 to 2048."""
    import torch

    from petal_decomposition_tpu_torch.ops.gram import guard_rmax

    k5 = ctx.k5
    inputs = {"incore_1Mx4096": lambda: make_data(ctx.dev, n=K5_ROWS[0],
                                                  d=K5_D, seed=SEED + 51),
              "stream_chunk_65536x4096": lambda: make_data(
                  ctx.dev, n=K5_ROWS[1], d=K5_D, seed=SEED + 50),
              "adversarial_1Mx4096": lambda: adversarial_data(
                  ctx.dev, K5_ROWS[0])}
    grade, sigma = {}, {}
    for name, make in inputs.items():
        x = make()
        for form in ("raw", "centered"):
            if form == "centered":
                x = x - x.mean(0)
            ref = f64_moments(x, rows=1 << 15)[2]
            row = k5_grade_row(ctx, x, ref)
            require(row["ratio"] <= 1.1,
                    f"K5 on {name} ({form}): {row}")
            grade[f"{name}.{form}"] = row
            if name == "incore_1Mx4096" and form == "raw":
                # σ of the centered Gram G − n·μμᵀ, as the fit forms it.
                n = x.shape[0]
                cs64 = f64_moments(x, rows=1 << 15)[0]
                mu64 = cs64 / n
                ref_s = torch.linalg.eigvalsh(
                    ref - n * torch.outer(mu64, mu64)).flip(0)[:K].sqrt()
                mu32 = (cs64 / n).float().double()
                with ctx.linalg.ieee_f32():
                    sigma["ieee_matmul"] = top_sigma_error(
                        x.mT @ x, mu32, n, ref_s)
                sigma["k5"] = top_sigma_error(k5.gram_syrk(x), mu32, n,
                                              ref_s)
            del ref
        del x
        torch.cuda.empty_cache()
    # Across n and d, from below the row floor up.
    sweep, min_d, min_rows = {}, k5.MIN_D, k5.MIN_ROWS
    k5.MIN_D, k5.MIN_ROWS = 1, 1
    try:
        makers = {"low_rank": lambda n, d, s: make_data(ctx.dev, n=n, d=d,
                                                        seed=s),
                  "shifted": lambda n, d, s: shifted_data(ctx.dev, n, d, s),
                  "adversarial": lambda n, d, s: adversarial_data(
                      ctx.dev, n, d, seed=s)}
        for d in (1536, 2048, 4096):
            for n in (1 << 14, 1 << 15, 1 << 16, 1 << 18):
                for name, make in makers.items():
                    x = make(n, d, SEED + 70 + n % 1009 + d)
                    for form in ("raw", "centered"):
                        if form == "centered":
                            x = x - x.mean(0)
                        row = k5_grade_row(
                            ctx, x, f64_moments(x, rows=1 << 15)[2])
                        if n >= min_rows and d >= min_d:
                            require(row["ratio"] <= 1.1,
                                    f"K5 at {n} × {d}, {name} ({form}): "
                                    f"{row}")
                        sweep[f"{d}.{n}.{name}.{form}"] = row
                    del x
        # The fused centering G − n·μμᵀ at the row floor, with the
        # mean-cancellation ratio r = n‖μ‖²/tr(Gc) just below the guard's
        # thresholds: K5's raw Gram in place of the matmul's.
        guard = {}
        for grade_name in ("default", "high"):
            r = 0.95 * guard_rmax(grade_name)
            # Unit columns (tr(Gc) ≈ n·d) shifted by √r·u, ‖u‖² ≈ d.
            x = torch.randn(min_rows, min_d, device=ctx.dev)
            x.add_(math.sqrt(r) * torch.randn(min_d, device=ctx.dev))
            cs64, _, g64 = f64_moments(x, rows=1 << 15)
            mu64 = cs64 / min_rows
            ref = g64 - min_rows * torch.outer(mu64, mu64)
            got_r = float(min_rows * mu64.square().sum() / ref.trace())
            mu = x.mean(0).double()
            with ctx.linalg.ieee_f32():
                lib = gram_errors(
                    (x.mT @ x).double() - min_rows * torch.outer(mu, mu), ref)
            got = gram_errors(
                k5.gram_syrk(x).double() - min_rows * torch.outer(mu, mu),
                ref)
            ratio = max(got["fro"] / lib["fro"], got["max"] / lib["max"])
            require(ratio <= 1.1, f"K5 on the fused centering at r = "
                    f"{got_r}: {got} against the matmul's {lib}")
            guard[grade_name] = {"r": got_r, "k5": got, "ieee_matmul": lib,
                                 "ratio": ratio}
            del x, ref, g64
    finally:
        k5.MIN_D, k5.MIN_ROWS = min_d, min_rows
    torch.cuda.empty_cache()
    times, err_max = {}, 0.0
    for n in K5_ROWS:
        x = make_data(ctx.dev, n=n, d=K5_D)
        reps, plain_reps = (5, 1) if n == K5_ROWS[0] else (20, 3)

        def ieee():
            with ctx.linalg.ieee_f32():
                return x.mT @ x

        if n == K5_ROWS[1]:
            plain = k5._gram_syrk_plain(x)
            err_max = rel_max(k5.gram_syrk(x), plain)
            # The tensor cores truncate where the plain version's IEEE
            # products round: 1.08e-6 apart on an H100.
            require(err_max <= K5_PLAIN_BAND,
                    f"K5 against its plain version {err_max} > "
                    f"{K5_PLAIN_BAND}")
            del plain
        bound_ms, bound_by = bound(
            n * K5_D * 4, {"tf32": n * K5_D * (K5_D + 1)})
        times[f"{n}x{K5_D}"] = {
            "ms": device_ms(lambda: k5.gram_syrk(x), reps),
            "plain_ms": cuda_ms(lambda: k5._gram_syrk_plain(x), plain_reps),
            "library_ms": device_ms(ieee, reps),
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        del x
        torch.cuda.empty_cache()
    # Both at 262,144 rows across d, K5 called below its MIN_D.
    crossover = {}
    k5.MIN_D = 1
    try:
        for d in (512, 1024, 1536, 2048):
            x = torch.randn(1 << 18, d, device=ctx.dev)

            def ieee():
                with ctx.linalg.ieee_f32():
                    return x.mT @ x

            crossover[d] = {"ms": device_ms(lambda: k5.gram_syrk(x), 10),
                            "library_ms": device_ms(ieee, 10)}
            del x
    finally:
        k5.MIN_D = min_d
    ctx.kernels["gram_syrk"].update(
        max_abs_err=err_max,
        **times[f"{K5_ROWS[0]}x{K5_D}"])
    return {"phase": "k5_grade", "chunk_rows": k5.CHUNK_ROWS,
            "min_d": k5.MIN_D, "min_rows": k5.MIN_ROWS, "grade": grade,
            "sigma_of_incore_gram": sigma, "sweep": sweep, "guard": guard,
            "times": times, "crossover_262144_rows": crossover}


# -- the single-device surface: complex RandomizedPca, save/load, the
# host C++ core and nan_debugging ---------------------------------------

# The complex fits: BASELINE config 2's shape in complex128, the
# flagship's in complex64 (8 GiB).
COMPLEX_FITS = {"complex128": (NR, DR, "complex128", SEED + 12),
                "complex64": (N, D, "complex64", SEED + 13)}


def complex_data(dev, n, d, dtype, seed):
    """:func:`make_data`'s low rank plus noise with complex directions,
    scores, noise and mean (each complex Gaussian draw has unit
    variance, split evenly between its real and imaginary parts)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=dev, dtype=dtype)

    basis = torch.linalg.qr(draw(d, K)).Q.mH
    scale = 3.0 * 0.9 ** torch.arange(K, device=dev, dtype=dtype.to_real())
    x = draw(n, d)
    x *= 0.05
    x += (draw(n, K) * scale) @ basis
    x += 0.1 * draw(d)
    return x


def complex_sigma_ref(x, k=K, rows: int = 1 << 16):
    """Top-k σ of X − 1μᵀ from the eigenvalues of its complex128 Gram
    XcᴴXc, formed by row chunks."""
    import torch

    c128 = torch.complex128
    d = x.shape[1]
    cs = torch.zeros(d, dtype=c128, device=x.device)
    gram = torch.zeros((d, d), dtype=c128, device=x.device)
    for i in range(0, x.shape[0], rows):
        c = x[i:i + rows].to(c128)
        cs += c.sum(0)
        gram += c.mH @ c
    mu = cs / x.shape[0]
    gc = gram - x.shape[0] * torch.outer(mu.conj(), mu)
    return torch.linalg.eigvalsh(gc).flip(0)[:k].clamp(min=0).sqrt()


@phase
def phase_randomized_complex(ctx):
    """``RandomizedPca(32)`` at its defaults on complex data, on the
    card: the JAX package's host autos (LU → P·L by its pivot rule,
    direct finder, explicit centering, Householder QR, cuSOLVER's SVD of
    B), so no kernel.  σ against the complex128 Gram at the randomized
    band, fit_transform against fit then transform; the LU and QR
    stages of one normalization timed on their panels."""
    import torch

    from petal_decomposition_tpu_torch.ops.linalg import lu_pl, mdot

    kernels = {"sketch_moments": ctx.k1, "jacobi_svd": ctx.k2,
               "jacobi_svd_f64": ctx.k3}
    out = {"phase": "randomized_complex", "k": K,
           "route": "host autos on the card: LU, direct, QR, torch.linalg"}
    for label, (n, d, dtype, seed) in COMPLEX_FITS.items():
        x = complex_data(ctx.dev, n, d, getattr(torch, dtype), seed)

        def make():
            return randomized_model(ctx.api, CUDA)

        make().fit(x)  # warm-up
        fit_ms, launches = [], {name: 0 for name in kernels}
        for _ in range(3):
            for mod in kernels.values():
                mod.launches = 0
            model = make().fit(x)
            for name, mod in kernels.items():
                launches[name] += mod.launches
            fit_ms.append(model.last_fit_stats_.wall_time_s * 1e3)
        require(not any(launches.values()),
                f"a complex fit launched a kernel: {launches}")
        s_ref = complex_sigma_ref(x)
        sig = float(((model.singular_values_.double() - s_ref).abs()
                     / s_ref).max())
        require(sig <= 1e-4, f"{label} σ relative error {sig} > 1e-4")
        z = model.transform(x)
        require(tuple(z.shape) == (n, K) and bool(torch.isfinite(z).all()),
                f"{label} transform is not finite (n, K)")
        z_ft = make().fit_transform(x)
        ft = rel_max(z_ft, z)
        ft_fro = float((z_ft - z).norm() / z.norm())
        del z_ft
        require(ft <= 1e-4, f"{label} fit_transform vs transform {ft}")
        omega = torch.randn(d, L, device=ctx.dev,
                            dtype=x.dtype.to_real()).to(x.dtype)
        y = mdot(x, omega)
        yt = mdot(x.mH, lu_pl(y))
        out[label] = {
            "x": [n, d], "fit_ms": fit_ms,
            "fit_ms_median": statistics.median(fit_ms),
            "launches_per_3_fits": launches, "sigma_rel_err_vs_c128": sig,
            "fit_transform_rel_err": ft, "fit_transform_fro_rel_err": ft_fro,
            "stages_ms": {
                "lu_pl_n_x_l": cuda_ms(lambda: lu_pl(y), 5),
                "lu_pl_d_x_l": cuda_ms(lambda: lu_pl(yt), 5),
                "qr_n_x_l": cuda_ms(lambda: torch.linalg.qr(y), 5),
                "x_times_panel": cuda_ms(lambda: mdot(x, omega), 5),
            },
        }
        del x, y, yt, z, model
        torch.cuda.empty_cache()
    return out


@phase
def phase_serialize(ctx):
    """``save``/``load`` on the card of config 1's ``Pca``, config 2's
    ``RandomizedPca``, a config-3 ``FastIca`` (float64) and the
    complex128 ``RandomizedPca``: the loaded model transforms bitwise as
    the saved one, the loaded ``RandomizedPca``'s and ``FastIca``'s next
    fit is bitwise the original's next fit, and a load on the CPU
    transforms within 1e-10."""
    import torch

    from petal_decomposition_tpu_torch.utils import serialize

    api, k3 = ctx.api, ctx.k3
    n, d, dtype, seed = COMPLEX_FITS["complex128"]
    cases = {
        "config1_pca": (lambda: api.PcaBuilder(64).device(CUDA).build(),
                        config1_data, False),
        "config2_randomized_pca": (lambda: randomized_model(api, CUDA),
                                   randomized64_data, True),
        "config3_fast_ica_f64": (lambda: ica_model(api, CUDA),
                                 ica64_data, True),
        "complex128_randomized_pca": (
            lambda: randomized_model(api, CUDA),
            lambda dev: complex_data(dev, n, d, torch.complex128, seed),
            True),
    }
    report = {}
    for name, (make, data, refit) in cases.items():
        x = data(ctx.dev)
        k3.launches = 0
        model = make().fit(x)
        launches = {"jacobi_svd_f64": k3.launches}
        ctx.add_launches(launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        blob = serialize.to_bytes(model)
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        loaded = serialize.from_bytes(blob, device=CUDA)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        z = model.transform(x)
        require(torch.equal(loaded.transform(x), z),
                f"{name}: the loaded model's transform is not bitwise")
        on_cpu = serialize.from_bytes(blob, device="cpu")
        cpu_err = rel_max(on_cpu.transform(x.cpu()), z.cpu())
        require(cpu_err <= 1e-10, f"{name}: CPU load transform {cpu_err}")
        entry = {"archive_bytes": len(blob), "save_ms": save_ms,
                 "load_ms": load_ms, "cpu_load_transform_rel_err": cpu_err,
                 "launches": launches}
        if refit:
            nxt, nxt_loaded = model.fit(x), loaded.fit(x)
            require(torch.equal(nxt_loaded.components_, nxt.components_),
                    f"{name}: the loaded model's next fit differs")
            entry["next_fit_bitwise"] = True
        report[name] = entry
        del x, z, model, loaded, on_cpu
        torch.cuda.empty_cache()
    return {"phase": "serialize", "models": report}


@contextlib.contextmanager
def config_set(**fields):
    """Set fields of the port's ``config`` for the block."""
    from petal_decomposition_tpu_torch import config

    old = {name: getattr(config, name) for name in fields}
    for name, value in fields.items():
        setattr(config, name, value)
    try:
        yield
    finally:
        for name, value in old.items():
            setattr(config, name, value)


@phase
def phase_native_offload(ctx):
    """BASELINE config 1 (1000 × 64 float64) through the host C++ core
    (``linalg_backend="native"``), through the tiny-fit offload
    (``"auto"`` with ``host_offload_max_elements = 1 << 18``) and on the
    card (direct K3): σ and σᵢ·componentsᵢ agree within 1e-10·σ₁; median
    fit ms of 20 each, by the fit's own clock (host to host, the copies
    of the host routes included)."""
    import torch

    from petal_decomposition_tpu_torch.utils import native

    k3 = ctx.k3
    x = config1_data(ctx.dev)
    t0 = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t0
    routes = {"native": {"linalg_backend": "native"},
              "auto_offload": {"host_offload_max_elements": 1 << 18},
              "card_k3": {}}
    out, models = {}, {}
    for route, fields in routes.items():
        with config_set(**fields):
            ctx.api.PcaBuilder(64).device(CUDA).build().fit(x)  # warm-up
            fit_ms, launches = [], 0
            for _ in range(20):
                k3.launches = 0
                m = ctx.api.PcaBuilder(64).device(CUDA).build().fit(x)
                launches += k3.launches
                fit_ms.append(m.last_fit_stats_.wall_time_s * 1e3)
        models[route] = m
        out[route] = {"fit_ms_median": statistics.median(fit_ms),
                      "fit_ms_min": min(fit_ms), "fit_ms_max": max(fit_ms),
                      "k3_launches_per_20_fits": launches}
    require(out["native"]["k3_launches_per_20_fits"] == 0
            and out["auto_offload"]["k3_launches_per_20_fits"] == 0,
            "a host route launched K3")
    require(out["card_k3"]["k3_launches_per_20_fits"] == 20,
            "the card's route did not launch K3 once a fit")
    ctx.add_launches({"jacobi_svd_f64": 20})
    ref = models["card_k3"]
    s1 = float(ref.singular_values_[0])
    for route in ("native", "auto_offload"):
        m = models[route]
        require(m.components_.device == ref.components_.device,
                f"{route}: the state is not on the model's device")
        sig = float((m.singular_values_ - ref.singular_values_).abs().max())
        comp = float(((m.components_ - ref.components_).abs()
                      * ref.singular_values_[:, None]).max())
        require(sig <= 1e-10 * s1 and comp <= 1e-10 * s1,
                f"{route} vs K3: σ {sig}, σ·components {comp}")
        out[route].update(sigma_abs_err_vs_k3=sig,
                          sigma_weighted_components_err_vs_k3=comp)
    return {"phase": "native_offload", "x": [1000, 64], "k": 64,
            "native_build_s": build_s, "routes": out,
            "host_over_card": out["native"]["fit_ms_median"]
            / out["card_k3"]["fit_ms_median"]}


def fpe_message(fn):
    """The message of the ``FloatingPointError`` that ``fn()`` raises;
    None if it returns."""
    try:
        fn()
    except FloatingPointError as e:
        return str(e)
    return None


def nan_panel(a):
    """A copy of panel ``a`` holding one NaN, as the transpose view of a
    contiguous tensor, so a Jacobi wrapper hands it to its kernel with
    no copy the mode would check first."""
    t = a.mT.contiguous()
    t[1, 7] = float("nan")
    return t.mT


@phase
def phase_nan_debugging(ctx):
    """The flagship data-route fit (K1 + K2) and config 1 (K3) inside
    ``nan_debugging()``: σ bitwise as without it, and the mode's
    overhead (median fit ms of 3 each way).  Then one NaN planted in
    config 1's X must raise ``FloatingPointError``, and a panel holding a
    NaN handed to each kernel under the mode must raise naming that
    kernel's wrapper."""
    import torch

    from petal_decomposition_tpu_torch.utils.debugging import nan_debugging

    k1, k2, k3 = ctx.k1, ctx.k2, ctx.k3
    fits = {
        "flagship_data_route": (lambda: data_route_model(ctx.api, CUDA),
                                make_data, {"sketch_moments": k1,
                                            "jacobi_svd": k2}),
        "config1": (lambda: ctx.api.PcaBuilder(64).device(CUDA).build(),
                    config1_data, {"jacobi_svd_f64": k3}),
    }
    out = {"phase": "nan_debugging"}
    for name, (make, data, kernels) in fits.items():
        x = data(ctx.dev)
        make().fit(x)  # warm-up
        plain = [make().fit(x) for _ in range(3)]
        with nan_debugging():
            checked = []
            for _ in range(3):
                for mod in kernels.values():
                    mod.launches = 0
                checked.append(make().fit(x))
                counts = {key: mod.launches for key, mod in kernels.items()}
                require(all(counts.values()),
                        f"{name} under the mode launched {counts}")
                ctx.add_launches(counts)
        for a, b in zip(plain, checked):
            require(torch.equal(a.singular_values_, b.singular_values_),
                    f"{name}: σ under nan_debugging is not bitwise")
        ms = [statistics.median(m.last_fit_stats_.wall_time_s * 1e3
                                for m in ms_) for ms_ in (plain, checked)]
        out[name] = {"fit_ms_median": ms[0],
                     "fit_ms_median_under_mode": ms[1],
                     "overhead": ms[1] / ms[0], "launches": counts}
        del x, plain, checked
        torch.cuda.empty_cache()
    x = config1_data(ctx.dev)
    x[17, 5] = float("nan")
    with nan_debugging():
        msg = fpe_message(
            lambda: ctx.api.PcaBuilder(64).device(CUDA).build().fit(x))
    require(msg is not None, "a NaN in config 1's X did not raise")
    out["planted_nan_in_x"] = msg
    x = config1_data(ctx.dev)
    panel = x - x.mean(0)
    w = torch.ones(x.shape[1], 16, device=ctx.dev, dtype=torch.float32)
    x32 = make_data(ctx.dev, 8192, 64, torch.float32, SEED + 14)
    x32[7, 1] = float("nan")
    p32, p64 = nan_panel(panel.float()), nan_panel(panel)
    kernel_cases = {
        "fused_sketch_moments (K1)": lambda: k1.fused_sketch_moments(x32, w),
        "jacobi_svd_vmem (K2)": lambda: k2.jacobi_svd_vmem(p32),
        "jacobi_svd_vmem_f64 (K3)": lambda: k3.jacobi_svd_vmem_f64(p64),
    }
    out["kernels"] = {}
    for wrapper, call in kernel_cases.items():
        with nan_debugging():
            msg = fpe_message(call)
        require(msg is not None and wrapper in msg,
                f"NaN out of {wrapper} raised {msg!r}")
        out["kernels"][wrapper] = msg
    return out


# -- streamed fits: the north-star stream, configs 2 and 3 streamed ------

# benchmarks/north_star.py's stream: 16 host blocks of 65536 × 4096 float32.
NS_BLOCKS, NS_ROWS, NS_D = 16, 65536, 4096
NS_N = NS_BLOCKS * NS_ROWS


@contextlib.contextmanager
def prefetch_depth(depth: int):
    """Run the block with ``PETAL_STREAM_PREFETCH`` set to ``depth``."""
    import os

    old = os.environ.get("PETAL_STREAM_PREFETCH")
    os.environ["PETAL_STREAM_PREFETCH"] = str(depth)
    try:
        yield
    finally:
        if old is None:
            del os.environ["PETAL_STREAM_PREFETCH"]
        else:
            os.environ["PETAL_STREAM_PREFETCH"] = old


def north_star_blocks(dev, keep=range(NS_BLOCKS), moments=True):
    """The north-star stream as 16 host (numpy) blocks: ``make_data``'s
    low rank plus noise with one basis and one mean across the blocks,
    made on the card and copied to host memory; and the stream's float64
    column sums, ‖X‖²_F and XᵀX, taken on the card block by block.  Only
    the blocks ``keep`` names go to the host (the multi-host phase's
    processes each keep theirs), and ``moments=False`` skips the float64
    moments (returned as None)."""
    import torch

    f64 = torch.float64
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 20)
    basis = torch.linalg.qr(
        torch.randn(NS_D, K, generator=g, device=dev)).Q.T
    scale = 3.0 * 0.9 ** torch.arange(K, device=dev, dtype=torch.float32)
    mean = 0.1 * torch.randn(NS_D, generator=g, device=dev)
    cs = torch.zeros(NS_D, dtype=f64, device=dev)
    sq = torch.zeros((), dtype=f64, device=dev)
    gram = torch.zeros((NS_D, NS_D), dtype=f64, device=dev)
    blocks = []
    for i in range(NS_BLOCKS):
        x = 0.05 * torch.randn(NS_ROWS, NS_D, generator=g, device=dev)
        x += (torch.randn(NS_ROWS, K, generator=g, device=dev)
              * scale) @ basis
        x += mean
        if moments:
            c = x.double()
            cs += c.sum(0)
            sq += (c * c).sum()
            gram += c.mT @ c
            del c
        if i in keep:
            blocks.append(x.cpu().numpy())
        del x
    if not moments:
        return blocks, None, None, None
    return blocks, cs, sq, gram


def centered_sigma(cs, gram, n, k=K):
    """Top-k σ of the centered data from its float64 moments."""
    import torch

    mu = cs / n
    gc = gram - n * torch.outer(mu, mu)
    return torch.linalg.eigvalsh(gc).flip(0)[:k].clamp(min=0).sqrt()


def host_gbps(nbytes: int, fn) -> float:
    """GB/s of ``fn`` moving ``nbytes``, by the host clock around it
    with the card synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return nbytes / (time.perf_counter() - t0) / 1e9


def feed_rates(blocks, dev):
    """The host→device feed of the north-star blocks, piece by piece, in
    GB/s: the stream's pipeline alone (``_device_prefetch`` at depth 2,
    nothing computed; the second of two passes, the first allocating the
    pinned ring), a pinned 1 GiB block's copy to the card (CUDA events,
    median of 5), and the host copy of the pageable blocks into a pinned
    buffer (``torch`` ``copy_``, which PyTorch runs on its CPU threads,
    as the pipeline's worker does)."""
    import torch

    from petal_decomposition_tpu_torch.models import streaming as pst

    nbytes = blocks[0].nbytes

    def pipeline():
        with prefetch_depth(2):
            for _ in pst._device_prefetch(iter(blocks), dev):
                pass

    pipeline()
    out = {"pipeline_only": host_gbps(NS_BLOCKS * nbytes, pipeline)}
    pinned = torch.empty(blocks[0].shape, pin_memory=True)
    pinned.copy_(torch.from_numpy(blocks[0]))
    devb = torch.empty(blocks[0].shape, device=dev)
    out["pinned_h2d"] = nbytes / cuda_ms(
        lambda: devb.copy_(pinned, non_blocking=True), 5) / 1e6

    def staged_torch():
        for b in blocks:
            pinned.copy_(torch.from_numpy(b))

    out["host_to_pinned_torch"] = host_gbps(NS_BLOCKS * nbytes, staged_torch)
    out["torch_threads"] = torch.get_num_threads()
    return out


def device_busy(prof, wall_ms: float) -> dict:
    """Busy shares of the card over a profiled fit: the union of its
    kernels' intervals, of its copies', and of both, over the fit's
    host wall time; None where the profiler recorded no device event."""
    import torch

    kernels, copies = [], []
    for e in prof.events():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        span = (e.time_range.start, e.time_range.end)
        (copies if "memcpy" in e.name.lower() else kernels).append(span)

    def union_ms(spans):
        total, end = 0.0, -math.inf
        for a, b in sorted(spans):
            if b > end:
                total += b - max(a, end)
                end = b
        return total / 1e3

    if not kernels:
        return {"kernels": None, "copies": None, "any": None}
    return {"kernels": union_ms(kernels) / wall_ms,
            "copies": union_ms(copies) / wall_ms,
            "any": union_ms(kernels + copies) / wall_ms,
            "kernel_events": len(kernels), "copy_events": len(copies)}


@phase
def phase_stream_north_star(ctx):
    """BASELINE's north-star shape streamed, literally
    ``benchmarks/north_star.py``'s stream: ``RandomizedPca(32).fit_batched``
    over 16 host blocks of 65536 × 4096 float32 (1,048,576 × 4096, 16 GiB),
    whose one hand-written kernel is K5, each block's Gram (16 launches a
    fit; f32 eighs of two 42×42 matrices besides).  Fit ms (median of 3)
    at prefetch depth 2 and 0,
    ingest GB/s, the feed's parts (:func:`feed_rates`), one block's
    ``_accum_step`` and Gram alone (CUDA events), the card's busy share
    over a fit (``torch.profiler``), and the in-core fit of the same
    matrix on the card, which launches K5 once a fit.  Gates: σ within
    1e-4 relative of the float64
    moments' (the randomized fits' band here; the Gram grade puts
    ≈ eps₃₂·(σ₁/σ₃₂)² ≈ 4e-5 on σ₃₂ at most), within 1e-5·σ₁ of the
    in-core fit at the same seed (the same recovery from two float32
    Grams), prefetch on and off bitwise equal (the check that no pinned
    buffer is reused early), and the mean-shift ratio under 1e-2."""
    import torch

    from petal_decomposition_tpu_torch.models import streaming as pst

    api, dev = ctx.api, ctx.dev
    t0 = time.perf_counter()
    blocks, cs, sq, gram = north_star_blocks(dev)
    ctx.ns_blocks = blocks
    ctx.ns_sigma = sigma_ref = centered_sigma(cs, gram, NS_N)
    make_s = time.perf_counter() - t0
    del gram
    torch.cuda.empty_cache()
    nbytes = sum(b.nbytes for b in blocks)

    def fit(depth):
        with prefetch_depth(depth):
            return api.RandomizedPca(K, seed=SEED, device=CUDA).fit_batched(
                blocks)

    def fit_ms(depth, reps):
        ms, model = [], None
        for _ in range(reps):
            model = fit(depth)
            ms.append(model.last_fit_stats_.wall_time_s * 1e3)
        return ms, model

    kernels = {"sketch_moments": ctx.k1, "jacobi_svd": ctx.k2,
               "jacobi_svd_f64": ctx.k3, "gram_syrk": ctx.k5}
    fit(2)  # warm-up
    for mod in kernels.values():
        mod.launches = 0
    ms2, m2 = fit_ms(2, 3)
    launches = {name: mod.launches for name, mod in kernels.items()}
    require(launches == {"sketch_moments": 0, "jacobi_svd": 0,
                         "jacobi_svd_f64": 0, "gram_syrk": 3 * NS_BLOCKS},
            f"north-star stream: launches in three fits {launches}, not "
            f"K5 alone, once a block")
    ctx.add_launches(launches)
    ms0, m0 = fit_ms(0, 2)
    ctx.ns_stream_sigma = m2.singular_values_
    ctx.ns_stream_components = m2.components_
    s = m2.singular_values_.double()
    sig = float(((s - sigma_ref).abs() / sigma_ref).max())
    require(sig <= 1e-4, f"north-star stream σ relative error {sig} > 1e-4")
    require(torch.equal(m2.singular_values_, m0.singular_values_)
            and torch.equal(m2.components_, m0.components_)
            and torch.equal(m2.mean_, m0.mean_),
            "north-star stream: prefetch depth 2 and 0 differ")
    ratio = m2.last_fit_stats_.extra["mean_shift_ratio"]
    require(ratio < 1e-2, f"north-star mean-shift ratio {ratio}")
    require(m2.last_fit_stats_.extra["streamed_blocks"] == NS_BLOCKS,
            "north-star stream: not 16 blocks")

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        mp = fit(2)
    busy = device_busy(prof, mp.last_fit_stats_.wall_time_s * 1e3)

    devb = torch.from_numpy(blocks[0]).to(dev)
    carry = (torch.zeros((NS_D, NS_D), dtype=torch.float64, device=dev),
             torch.zeros(NS_D, dtype=torch.float64, device=dev),
             torch.zeros((), dtype=torch.float64, device=dev))
    shift = devb.double().mean(0)
    accum_ms = cuda_ms(
        lambda: pst._accum_step(carry, devb, shift), 5)
    gram_ms = cuda_ms(lambda: ctx.k5.gram_syrk(devb), 5)
    del devb, carry
    feed = feed_rates(blocks, dev)

    # The in-core fit of the same 16 GiB matrix on the card.
    x = torch.empty((NS_N, NS_D), device=dev)
    for i, b in enumerate(blocks):
        x[i * NS_ROWS:(i + 1) * NS_ROWS].copy_(torch.from_numpy(b))
    api.RandomizedPca(K, seed=SEED, device=CUDA).fit(x)  # warm-up
    incore_ms, incore_launches, incore = timed_fits(
        lambda: api.RandomizedPca(K, seed=SEED, device=CUDA), x,
        {"gram_syrk": ctx.k5})
    require(incore_launches == {"gram_syrk": 3},
            f"north-star in core: K5 launches in three fits "
            f"{incore_launches}, not one a fit")
    ctx.add_launches(incore_launches)
    del x
    torch.cuda.empty_cache()
    s_in = incore.singular_values_.double()
    vs_incore = float((s - s_in).abs().max() / s_in[0])
    require(vs_incore <= 1e-5,
            f"north-star stream vs in-core σ {vs_incore} > 1e-5·σ₁")
    med2 = statistics.median(ms2)
    # The Grams' rate, counted as full float32 products (2·n·d²).
    flops = 2.0 * NS_N * NS_D * NS_D
    return {"phase": "stream_north_star", "x": [NS_N, NS_D],
            "blocks": [NS_BLOCKS, NS_ROWS], "k": K,
            "route": "fit_batched: K5's Gram per block, f64 carry, "
                     "zero-pass Gram recovery",
            "data_s": make_s, "fit_ms_depth2": ms2, "fit_ms_median": med2,
            "fit_ms_depth0": ms0,
            "ingest_gb_s": nbytes / (med2 / 1e3) / 1e9,
            "launches_per_3_fits": launches,
            "feed_gb_s": feed,
            "h2d_alone_ms_at_pinned_rate": nbytes / feed["pinned_h2d"] / 1e6,
            "accum_step_one_block_ms": accum_ms,
            "gram_one_block_ms": gram_ms,
            "gram_tflop_s": flops / NS_BLOCKS / (gram_ms / 1e3) / 1e12,
            "device_busy_share": busy,
            "compute_idle_share_from_events": 1 - (
                NS_BLOCKS * accum_ms / med2),
            "incore_fit_ms": incore_ms,
            "incore_launches_per_3_fits": incore_launches,
            "incore_fit_ms_median": statistics.median(incore_ms),
            "sigma_rel_err_vs_f64": sig, "sigma_vs_incore": vs_incore,
            "mean_shift_ratio": ratio,
            "prefetch_on_off_bitwise_equal": True}


@phase
def phase_stream_exact(ctx):
    """Exact ``Pca(32).fit_batched``: on the north-star stream (float32;
    σ within 1e-4 of the float64 moments', through cuSOLVER's eigh of the
    4096² Gram) and on the 200,000 × 256 float64 table in 65536-row blocks
    (σ within 1e-9·σ₁ of the centered table's singular values, the Gram
    grade; K3 once a fit, on the 256² Gram); with the time of each eigh
    inside the fit."""
    import torch

    api, k3, linalg = ctx.api, ctx.k3, ctx.linalg
    from petal_decomposition_tpu_torch.models import streaming as pst

    blocks = ctx.ns_blocks
    api.Pca(K, device=CUDA).fit_batched(blocks)  # warm-up
    ms32 = []
    for _ in range(2):
        m32 = api.Pca(K, device=CUDA).fit_batched(blocks)
        ms32.append(m32.last_fit_stats_.wall_time_s * 1e3)
    s_ref = ctx.ns_sigma
    ctx.ns_exact_sigma = m32.singular_values_
    ctx.ns_exact_components = m32.components_
    sig32 = float(((m32.singular_values_.double() - s_ref).abs()
                   / s_ref).max())
    require(sig32 <= 1e-4, f"exact f32 stream σ error {sig32} > 1e-4")
    moments = pst.accumulate_moments(blocks, device=CUDA)
    g32 = moments.gram.float()
    eigh32_ms = cuda_ms(lambda: linalg.eigh_psd_jit_cert(g32), 3)
    del moments, g32

    x64 = pca64_data(ctx.dev)
    s64 = torch.linalg.svdvals(x64 - x64.mean(0))
    host64 = x64.cpu().numpy()
    del x64
    api.Pca(K, device=CUDA).fit_batched(host64)  # warm-up
    k3.launches = 0
    fit_ms64, counts = [], []
    for _ in range(3):
        m64 = api.Pca(K, device=CUDA).fit_batched(host64)
        fit_ms64.append(m64.last_fit_stats_.wall_time_s * 1e3)
        counts.append(k3.launches)
    launches = {"jacobi_svd_f64": k3.launches}
    require(counts == [1, 2, 3], f"K3 not once a float64 stream {counts}")
    ctx.add_launches(launches)
    sig64 = float((m64._singular_full - s64).abs().max() / s64[0])
    require(sig64 <= 1e-9, f"exact f64 stream σ error {sig64} > 1e-9·σ₁")
    g64 = pst.accumulate_moments(host64, device=CUDA).gram
    eigh64_ms = cuda_ms(lambda: linalg.eigh_psd_jit_cert(g64), 5)
    ctx.host64 = host64
    return {"phase": "stream_exact",
            "f32": {"x": [NS_N, NS_D], "fit_ms": ms32,
                    "sigma_rel_err_vs_f64": sig32,
                    "eigh_4096_cusolver_ms": eigh32_ms},
            "f64": {"x": [N64, D64], "block_rows": 65536,
                    "fit_ms": fit_ms64,
                    "fit_ms_median": statistics.median(fit_ms64),
                    "launches_per_3_fits": launches,
                    "sigma_err_over_sigma1": sig64,
                    "eigh_256_k3_ms": eigh64_ms}}


@phase
def phase_stream_randomized_f64(ctx):
    """BASELINE config 2 streamed: ``RandomizedPca(32).fit_batched`` of the
    100,000 × 1024 float64 table from host blocks; its Gram recovery's two
    42×42 eighs are K3.  σ within 1e-9·σ₁ of the in-core zero-pass
    Gram-recovery fit at the same seed (the same Ω and recovery, from two
    float64 Grams)."""
    import torch

    api, k3 = ctx.api, ctx.k3
    x = randomized64_data(ctx.dev)
    host = x.cpu().numpy()
    incore = gram_recovery_model(api, CUDA).fit(x)
    del x

    def make():
        return api.RandomizedPca(K, seed=SEED, device=CUDA)

    make().fit_batched(host)  # warm-up
    k3.launches = 0
    fit_ms, counts = [], []
    for _ in range(3):
        m = make().fit_batched(host)
        fit_ms.append(m.last_fit_stats_.wall_time_s * 1e3)
        counts.append(k3.launches)
    require(counts == [2, 4, 6], f"K3 not twice a config-2 stream {counts}")
    launches = {"jacobi_svd_f64": k3.launches}
    ctx.add_launches(launches)
    s, s_in = m.singular_values_, incore.singular_values_
    sig = float((s - s_in).abs().max() / s_in[0])
    require(sig <= 1e-9, f"config-2 stream vs in-core σ {sig} > 1e-9·σ₁")
    del host
    torch.cuda.empty_cache()
    return {"phase": "stream_randomized_f64", "x": [NR, DR], "k": K,
            "route": "fit_batched: f64 Gram, zero-pass recovery, K3 eighs",
            "fit_ms": fit_ms, "fit_ms_median": statistics.median(fit_ms),
            "incore_fit_ms": incore.last_fit_stats_.wall_time_s * 1e3,
            "launches_per_3_fits": launches, "sigma_vs_incore": sig}


@phase
def phase_partial_fit(ctx):
    """``Pca(32).partial_fit``: the 200k × 256 float64 table one 65536-row
    block a call (with a malformed call between, which must leave the
    stream as it was), then the 16 north-star blocks one a call.  After
    the last call σ and components equal ``fit_batched`` on the same
    blocks, within 1e-10 (float64) and 1e-5 (float32) relative."""
    import numpy as np

    api, k3 = ctx.api, ctx.k3
    host64 = ctx.host64
    parts = [host64[i:i + 65536] for i in range(0, N64, 65536)]
    ref64 = api.Pca(K, device=CUDA).fit_batched(parts)
    k3.launches = 0
    m = api.Pca(K, device=CUDA)
    call_ms = []
    for i, part in enumerate(parts):
        m.partial_fit(part)
        call_ms.append(m.last_fit_stats_.wall_time_s * 1e3)
        if i == 1:
            rows = m._n_samples
            try:
                m.partial_fit([part, np.zeros((10, D64 + 1))])
            except api.InvalidInput:
                pass
            else:
                require(False, "a malformed partial_fit call was accepted")
            require(m._n_samples == rows and m._stream.n == rows,
                    "a failed partial_fit call changed the stream")
    launches = {"jacobi_svd_f64": k3.launches}
    require(k3.launches == len(parts), "K3 not once a float64 call")
    ctx.add_launches(launches)

    def agreement(a, b):
        s = float(((a.singular_values_ - b.singular_values_).abs()
                   / b.singular_values_).max())
        c = rel_max(a.components_, b.components_)
        return s, c

    s64, c64 = agreement(m, ref64)
    require(s64 <= 1e-10 and c64 <= 1e-10,
            f"float64 partial_fit vs fit_batched σ {s64}, components {c64}")
    blocks = ctx.ns_blocks
    ref32 = api.Pca(K, device=CUDA).fit_batched(blocks)
    m32 = api.Pca(K, device=CUDA)
    call32_ms = []
    for b in blocks:
        m32.partial_fit(b)
        call32_ms.append(m32.last_fit_stats_.wall_time_s * 1e3)
    s32, c32 = agreement(m32, ref32)
    require(s32 <= 1e-5 and c32 <= 1e-5,
            f"float32 partial_fit vs fit_batched σ {s32}, components {c32}")
    require(m32.last_fit_stats_.extra["partial_fit_calls"] == NS_BLOCKS,
            "partial_fit_calls not recorded")
    del ctx.ns_blocks, ctx.host64
    return {"phase": "partial_fit",
            "f64": {"x": [N64, D64], "calls": len(parts),
                    "call_ms": call_ms, "launches": launches,
                    "sigma_rel_vs_fit_batched": s64,
                    "components_rel_vs_fit_batched": c64},
            "f32": {"x": [NS_N, NS_D], "calls": NS_BLOCKS,
                    "call_ms": call32_ms,
                    "sigma_rel_vs_fit_batched": s32,
                    "components_rel_vs_fit_batched": c32}}


@phase
def phase_stream_fast_ica(ctx):
    """BASELINE config 3 streamed: ``FastIca.fit_batched`` of the 100k × 64
    Laplace mixture from host blocks through a callable re-iterable, two
    passes.  float64 at full precision against the in-core
    ``whiten_solver="eigh"`` fit at the same seed: the same n_iter and
    components within 1e-6 relative (the JAX package's streamed band; its
    whitened inputs differ by float64 accumulation roundoff only).
    float64 and float32 at the card's defaults: Amari distance ≤
    ``AMARI_MAX`` and every source recovered one to one, as
    ``fast_ica_config3`` checks.  Fit ms, iterations a second and the
    whitened buffer's fill time (the second pass, host clock around it)."""
    import torch

    from petal_decomposition_tpu_torch.models import streaming as pst

    api, k3 = ctx.api, ctx.k3
    s, a = ica_sources(ctx.dev)
    x64 = s @ a.mT
    del s
    fills = []
    real_fill = pst._fill_pass

    def timed_fill(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        real_fill(*args, **kw)
        torch.cuda.synchronize()
        fills.append((time.perf_counter() - t0) * 1e3)

    out = {}
    pst._fill_pass = timed_fill
    try:
        for name, x, knobs in (
                ("f64_full", x64, {"iteration_precision": "full"}),
                ("f64_defaults", x64, {}),
                ("f32_defaults", x64.float(), {})):
            host = x.cpu().numpy()
            parts = [host[i:i + 65536] for i in range(0, NI, 65536)]

            def stream():
                return iter(parts)

            ica_model(api, CUDA, **knobs).fit_batched(stream)  # warm-up
            fit_ms, counts = [], []
            for _ in range(3):
                k3.launches = 0
                fills.clear()
                m = ica_model(api, CUDA, **knobs).fit_batched(stream)
                fit_ms.append(m.last_fit_stats_.wall_time_s * 1e3)
                counts.append(k3.launches)
            if x.dtype == torch.float64:
                require(all(c > 0 for c in counts),
                        f"streamed FastIca {name} launched no K3")
            for c in counts:
                ctx.add_launches({"jacobi_svd_f64": c})
            comp = m.components_.double()
            amari = amari_distance(comp @ a)
            require(amari <= AMARI_MAX,
                    f"streamed FastIca {name}: Amari distance {amari}")
            ratio = sources_recovered(comp @ a)
            require(ratio >= SOURCE_RATIO_MIN,
                    f"streamed FastIca {name}: a source's ratio {ratio}")
            med = statistics.median(fit_ms)
            row = {"knobs": knobs, "fit_ms": fit_ms, "fit_ms_median": med,
                   "n_iter": m.n_iter_, "iters_per_s": m.n_iter_ / med * 1e3,
                   "fill_ms": fills[-1], "k3_launches_per_fit": counts,
                   "amari_distance": amari, "min_source_ratio": ratio,
                   "whitened_buffer_cols":
                       m.last_fit_stats_.extra["whitened_buffer_cols"]}
            if name == "f64_full":
                ic = ica_model(api, CUDA, whiten_solver="eigh",
                               **knobs).fit(x)
                row["incore_n_iter"] = ic.n_iter_
                row["components_rel_vs_incore"] = rel_max(
                    m.components_, ic.components_)
                require(m.n_iter_ == ic.n_iter_,
                        f"streamed n_iter {m.n_iter_} vs {ic.n_iter_}")
                require(row["components_rel_vs_incore"] <= 1e-6,
                        "streamed FastIca vs in-core components "
                        f"{row['components_rel_vs_incore']}")
            out[name] = row
    finally:
        pst._fill_pass = real_fill
    del x64
    torch.cuda.empty_cache()
    return {"phase": "stream_fast_ica", "x": [NI, KI], "block_rows": 65536,
            "fits": out}


# -- meshes: one rank of NCCL, several shards on one card, two processes --

# 1,000,003 rows on four shards: the last shard carries one zero row.
MESH_N_PADDED = 1_000_003
# How long the multi-host phase waits for its two processes.
MH_TIMEOUT_S = 420


def free_port() -> int:
    """A free TCP port on localhost, for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def timed_collectives():
    """Host seconds spent in ``torch.distributed``'s collectives while
    the block runs, the card synchronized before and after each call so
    that the time is the collective's own and not queued work: yields a
    dict whose ``"seconds"`` grows as they run."""
    import torch
    import torch.distributed as dist

    spent = {"seconds": 0.0}
    saved = {name: getattr(dist, name) for name in
             ("all_reduce", "all_gather", "all_gather_into_tensor")}

    def timing(fn):
        @functools.wraps(fn)
        def run(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            spent["seconds"] += time.perf_counter() - t0
            return out
        return run

    for name, fn in saved.items():
        setattr(dist, name, timing(fn))
    try:
        yield spent
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


def mesh_data_route(api, mesh):
    """The flagship's data route (K1, then K2 on Bᵀ) on ``mesh``."""
    return (api.RandomizedPcaBuilder(K).seed(SEED).range_finder("gram")
            .gram_projection("data").mesh(mesh).build())


def agreement(sigma, comps, sigma_ref, comps_ref) -> dict:
    """σ relative to each reference σ and to σ₁, and the largest entry
    of the difference of the unit-norm component rows (the JAX package's
    sharded-against-unsharded measure; rows signed by ``svd_flip`` on
    both sides, compared sign-canonically all the same)."""
    s, s_ref = sigma.double().cpu(), sigma_ref.double().cpu()
    c, c_ref = comps.double().cpu(), comps_ref.double().cpu()
    c = c * (c * c_ref).sum(1, keepdim=True).sign()
    return {"sigma_rel": float(((s - s_ref).abs() / s_ref).max()),
            "sigma_err_over_sigma1": float((s - s_ref).abs().max()
                                           / s_ref[0]),
            "components_max_abs": float((c - c_ref).abs().max())}


def fit_pair(make_free, make_mesh_fit, x, kernels, reps=2):
    """One warm-up each, then ``reps`` timed fits each (launches counted
    around the mesh fits only): ``(free ms, mesh ms, mesh launches, free
    model, mesh model)``."""
    make_free().fit(x)
    make_mesh_fit().fit(x)
    free_ms, _, free = timed_fits(make_free, x, {}, reps)
    mesh_ms, launches, meshed = timed_fits(make_mesh_fit, x, kernels, reps)
    return free_ms, mesh_ms, launches, free, meshed


@phase
def phase_mesh_one_card(ctx):
    """The collective path on one card: a one-rank NCCL group (tcp on
    localhost) and ``make_mesh()`` over it, the flagship 1M × 1024 float32
    ``RandomizedPca(32)`` on the data route (K1 on the one shard, K2 on
    Bᵀ; every reduction one NCCL all-reduce) against the mesh-free fit:
    σ and components within 1e-5, fit ms of both, and the collectives'
    calls, bytes and seconds (one more fit with the card synchronized
    around each collective)."""
    import torch
    import torch.distributed as dist

    from petal_decomposition_tpu_torch.parallel import distributed as pdist
    from petal_decomposition_tpu_torch.parallel import make_mesh, multihost

    api = ctx.api
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = make_mesh()
        require(mesh.size == 1 and mesh.group is not None
                and dist.get_backend() == "nccl", "not a one-rank NCCL mesh")
        x = make_data(ctx.dev)
        kernels = {"sketch_moments": ctx.k1, "jacobi_svd": ctx.k2}
        pdist.collectives.reset()
        free_ms, mesh_ms, launches, free, meshed = fit_pair(
            lambda: data_route_model(api, CUDA),
            lambda: mesh_data_route(api, mesh), x, kernels, reps=3)
        calls = pdist.collectives.calls
        require(launches["sketch_moments"] == 3, "K1 not once a fit")
        ctx.add_launches(launches)
        pdist.collectives.reset()
        with timed_collectives() as spent:
            timed = mesh_data_route(api, mesh).fit(x)
        coll = {"calls_per_fit": pdist.collectives.calls,
                "bytes_per_fit": pdist.collectives.bytes,
                "seconds_per_fit": spent["seconds"],
                "fit_ms_synchronized": timed.last_fit_stats_.wall_time_s
                * 1e3}
        require(calls == 4 * coll["calls_per_fit"],
                "a fit's collectives changed between fits")
    finally:
        dist.destroy_process_group()
    agree = agreement(meshed.singular_values_, meshed.components_,
                      free.singular_values_, free.components_)
    require(agree["sigma_rel"] <= 1e-5
            and agree["components_max_abs"] <= 1e-5,
            f"one-rank mesh vs mesh-free {agree}")
    del x
    torch.cuda.empty_cache()
    return {"phase": "mesh_one_card", "x": [N, D], "k": K,
            "group": "nccl, 1 rank", "route": "range_finder=gram, "
            "gram_projection=data", "fit_ms_mesh_free": free_ms,
            "fit_ms_mesh": mesh_ms, "launches_per_3_fits": launches,
            "collectives": coll, **agree}


@phase
def phase_mesh_shards(ctx):
    """Several shards on one card, each fit against the same fit without
    a mesh: the flagship's route on 1,000,003 × 1024 float32 over four
    shards (the last padded with a zero row; K1 four times a fit, each
    shard's output held against K1's plain version first); exact
    ``Pca(32)`` float64 on 200k × 256 over three shards (the Gram route,
    K3 on the replicated 256² eigh); BASELINE config 3 (``FastIca``,
    float64) over two shards at 30 iterations with K3 every step, and at
    the card's defaults; and BASELINE config 4's width, ``RandomizedPca(32)``
    on 1,048,576 × 4096 float32 over four shards — config 4 has 10M rows
    (164 GB), which one 80 GB card cannot hold, so the rows are cut to the
    north-star matrix's 1M (16 GiB).  Bands: float32 σ 1e-5 and
    components 1e-4 (the JAX package's sharded-against-unsharded bands),
    float64 1e-10, FastIca 1e-9 (as ``fast_ica_card_vs_cpu``)."""
    import torch

    from petal_decomposition_tpu_torch.parallel import (
        make_mesh,
        shard_rows_padded,
    )

    api, k1, k2, k3, dev = ctx.api, ctx.k1, ctx.k2, ctx.k3, ctx.dev
    out = {}

    # The flagship's route, four shards, the last padded.
    mesh4 = make_mesh(4, devices=[CUDA] * 4)
    x = make_data(dev, n=MESH_N_PADDED)
    xs, n = shard_rows_padded(x, mesh4)
    require(xs.padded and xs.valid == [xs.rows_per_shard] * 3
            + [xs.rows_per_shard - 1], f"padding not as planned {xs.valid}")
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    w = torch.randn(D, L, generator=g, device=dev)
    ys, cs, sq = k1.fused_sketch_moments_on(xs, w)
    shard_errs = []
    for s, y in zip(xs.shards, ys.shards):
        yp, _, _ = k1._sketch_moments_plain(s, w)
        err = float((y - yp).abs().max())
        require(err <= 1e-4 * float(yp.abs().max()),
                f"K1 on a shard: Y error {err}")
        shard_errs.append(err)
    cs64, sq64, _ = f64_moments(x)
    sq_rel = abs(float(sq) - float(sq64)) / float(sq64)
    require(sq_rel <= 1e-5, f"K1 per shard: reduced ‖X‖² error {sq_rel}")
    per_shard_ms = cuda_ms(lambda: k1.fused_sketch_moments_on(xs, w),
                           10)
    whole_ms = cuda_ms(lambda: k1.fused_sketch_moments(x, w), 10)
    del ys, xs
    kernels = {"sketch_moments": k1, "jacobi_svd": k2}
    free_ms, mesh_ms, launches, free, meshed = fit_pair(
        lambda: data_route_model(api, CUDA),
        lambda: mesh_data_route(api, mesh4), x, kernels)
    require(launches["sketch_moments"] == 2 * 4, "K1 not four times a fit")
    ctx.add_launches(launches)
    agree = agreement(meshed.singular_values_, meshed.components_,
                      free.singular_values_, free.components_)
    require(agree["sigma_rel"] <= 1e-5
            and agree["components_max_abs"] <= 1e-4,
            f"4-shard flagship vs mesh-free {agree}")
    out["flagship_padded"] = {
        "x": [MESH_N_PADDED, D], "shards": 4, "rows_per_shard":
        -(-MESH_N_PADDED // 4), "k1_shard_y_max_abs_err": shard_errs,
        "k1_sqnorm_rel_err": sq_rel, "k1_4_shards_ms": per_shard_ms,
        "k1_whole_ms": whole_ms, "fit_ms_mesh_free": free_ms,
        "fit_ms_mesh": mesh_ms, "launches_per_2_fits": launches, **agree}
    del x, free, meshed
    torch.cuda.empty_cache()

    # Exact float64 Pca, the Gram route, three shards.
    mesh3 = make_mesh(3, devices=[CUDA] * 3)
    x64 = pca64_data(dev)
    free_ms, mesh_ms, launches, free, meshed = fit_pair(
        lambda: exact_model(api, CUDA, "gram"),
        lambda: api.PcaBuilder(K).mesh(mesh3).build(), x64,
        {"jacobi_svd_f64": k3})
    ctx.add_launches(launches)
    agree = agreement(meshed.singular_values_, meshed.components_,
                      free.singular_values_, free.components_)
    require(agree["sigma_rel"] <= 1e-10
            and agree["components_max_abs"] <= 1e-10,
            f"3-shard exact f64 vs mesh-free {agree}")
    out["pca_f64_gram"] = {"x": [N64, D64], "shards": 3,
                           "fit_ms_mesh_free": free_ms,
                           "fit_ms_mesh": mesh_ms,
                           "launches_per_2_fits": launches, **agree}
    del x64, free, meshed

    # BASELINE config 3, two shards.
    mesh2 = make_mesh(2, devices=[CUDA] * 2)
    s, a = ica_sources(dev)
    xi = s @ a.mT
    del s
    fixed = dict(tol=0.0, max_iter=ICA_CHECK_ITERS, decorrelation="eigh",
                 iteration_precision="full")
    free_ms, mesh_ms, launches, free, meshed = fit_pair(
        lambda: ica_model(api, CUDA, whiten_solver="eigh", **fixed),
        lambda: api.FastIca(seed=SEED, mesh=mesh2, **fixed), xi,
        {"jacobi_svd_f64": k3})
    ctx.add_launches(launches)
    ctx.ica_mesh_ref = free.components_
    want, got = free.components_.double(), meshed.components_.double()
    got = got * (got * want).sum(1, keepdim=True).sign()
    ica_rel = rel_max(got, want)
    require(meshed.n_iter_ == free.n_iter_ == ICA_CHECK_ITERS,
            f"mesh FastIca n_iter {meshed.n_iter_}, {free.n_iter_}")
    require(ica_rel <= 1e-9, f"2-shard FastIca vs mesh-free {ica_rel}")
    k3.launches = 0
    dm = api.FastIca(seed=SEED, mesh=mesh2).fit(xi)
    ctx.add_launches({"jacobi_svd_f64": k3.launches})
    amari = amari_distance(dm.components_.double() @ a)
    ratio = sources_recovered(dm.components_.double() @ a)
    require(amari <= AMARI_MAX and ratio >= SOURCE_RATIO_MIN,
            f"mesh FastIca at the defaults: Amari {amari}, ratio {ratio}")
    out["fast_ica_config3"] = {
        "x": [NI, KI], "shards": 2, "fixed_knobs": fixed,
        "fit_ms_mesh_free": free_ms, "fit_ms_mesh": mesh_ms,
        "launches_per_2_fits": launches, "components_rel": ica_rel,
        "defaults": {"fit_ms": dm.last_fit_stats_.wall_time_s * 1e3,
                     "n_iter": dm.n_iter_, "amari_distance": amari,
                     "min_source_ratio": ratio}}
    del xi, free, meshed, dm

    # BASELINE config 4's width at the north-star matrix's rows.
    torch.cuda.empty_cache()
    x = make_data(dev, n=NS_N, d=NS_D, seed=SEED + 20)
    torch.cuda.empty_cache()
    free_ms, mesh_ms, launches, free, meshed = fit_pair(
        lambda: data_route_model(api, CUDA),
        lambda: mesh_data_route(api, mesh4), x, kernels)
    require(launches["sketch_moments"] == 2 * 4, "K1 not four times a fit")
    ctx.add_launches(launches)
    agree = agreement(meshed.singular_values_, meshed.components_,
                      free.singular_values_, free.components_)
    require(agree["sigma_rel"] <= 1e-5
            and agree["components_max_abs"] <= 1e-4,
            f"config 4 width, 4 shards vs mesh-free {agree}")
    out["config4_width"] = {
        "x": [NS_N, NS_D], "shards": 4,
        "reduced": "BASELINE config 4 is 10,000,000 x 4096 float32 "
                   "(164 GB) on 8 devices; one 80 GB card holds 1,048,576 "
                   "rows (16 GiB), so the rows are cut to those",
        "fit_ms_mesh_free": free_ms, "fit_ms_mesh": mesh_ms,
        "launches_per_2_fits": launches, **agree}
    del x, free, meshed
    torch.cuda.empty_cache()
    return {"phase": "mesh_shards", "fits": out}


def multihost_child(rank: int, port: int, work: str) -> int:
    """One of the multi-host phase's two processes: a gloo group on the
    one card, two shards each (a mesh of four).  In core: the flagship
    data route and config 3's FastIca on the whole matrix; streamed: the
    north-star stream's 16 blocks split 8 / 8 by process, through
    ``RandomizedPca`` and ``Pca`` ``fit_batched`` and two lockstep
    ``partial_fit`` calls.  Replicated state must be bitwise equal on
    both processes; process 0 holds σ, components and FastIca against the
    single-process fits in ``refs.pt``.  Writes ``rank<r>.json``."""
    import os

    import torch
    import torch.distributed as dist

    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops.kernels import (
        jacobi_f64_kernel as k3,
        jacobi_kernels as k2,
        sketch_kernel as k1,
    )
    from petal_decomposition_tpu_torch.parallel import distributed as pdist
    from petal_decomposition_tpu_torch.parallel import make_mesh, multihost

    dev = torch.device(CUDA)
    multihost.initialize(f"localhost:{port}", 2, rank, backend="gloo")
    mesh = make_mesh(devices=[CUDA] * 2)
    require(mesh.size == 4 and mesh.world == 2, f"mesh {mesh}")
    refs = torch.load(os.path.join(work, "refs.pt"))
    kernels = {"sketch_moments": k1, "jacobi_svd": k2, "jacobi_svd_f64": k3}
    launches = {name: 0 for name in kernels}
    out = {"rank": rank, "mesh": repr(mesh)}
    state = []

    def counted(fit):
        for mod in kernels.values():
            mod.launches = 0
        model = fit()
        for name, mod in kernels.items():
            launches[name] += mod.launches
        return model

    # The flagship, the whole matrix on both processes.
    x = make_data(dev)
    mesh_data_route(api, mesh).fit(x)  # warm-up
    t0 = time.perf_counter()
    m = counted(lambda: mesh_data_route(api, mesh).fit(x))
    out["flagship_fit_ms"] = (time.perf_counter() - t0) * 1e3
    require(launches["sketch_moments"] == 2, "K1 not once a local shard")
    pdist.collectives.reset()
    with timed_collectives() as spent:
        timed = mesh_data_route(api, mesh).fit(x)
    out["flagship_collectives"] = {
        "calls": pdist.collectives.calls, "bytes": pdist.collectives.bytes,
        "seconds": spent["seconds"],
        "fit_ms_synchronized": timed.last_fit_stats_.wall_time_s * 1e3}
    y = m.fit_transform(x)
    require(tuple(y.shape) == (N, K), f"fit_transform shape {tuple(y.shape)}")
    state += [m.singular_values_, m.components_, y[::997]]
    out["flagship"] = agreement(m.singular_values_, m.components_,
                                refs["slice_sigma"], refs["slice_components"])
    del x, y

    # Config 3's FastIca, the whole matrix on both processes.
    s, a = ica_sources(dev)
    xi = s @ a.mT
    del s
    fixed = dict(tol=0.0, max_iter=ICA_CHECK_ITERS, decorrelation="eigh",
                 iteration_precision="full")
    ica = counted(lambda: api.FastIca(seed=SEED, mesh=mesh, **fixed).fit(xi))
    want, got = refs["ica"].double(), ica.components_.double().cpu()
    got = got * (got * want).sum(1, keepdim=True).sign()
    out["fast_ica_components_rel"] = rel_max(got, want)
    dm = counted(lambda: api.FastIca(seed=SEED, mesh=mesh).fit(xi))
    out["fast_ica_defaults"] = {
        "n_iter": dm.n_iter_,
        "amari_distance": amari_distance(dm.components_.double() @ a)}
    state += [ica.components_, dm.components_]
    del xi

    # The north-star stream, blocks 8r … 8r + 7 on process r.
    mine = range(8 * rank, 8 * rank + 8)
    blocks, *_ = north_star_blocks(dev, keep=mine, moments=False)
    torch.cuda.empty_cache()
    r = counted(lambda: api.RandomizedPca(K, seed=SEED, mesh=mesh)
                .fit_batched(blocks))
    out["stream_randomized_fit_ms"] = r.last_fit_stats_.wall_time_s * 1e3
    e = counted(lambda: api.Pca(K, mesh=mesh).fit_batched(blocks))
    out["stream_exact_fit_ms"] = e.last_fit_stats_.wall_time_s * 1e3
    pf = api.Pca(K, mesh=mesh)
    pf.partial_fit(blocks[:4])
    pf.partial_fit(blocks[4:])
    require(pf.last_fit_stats_.extra["partial_fit_calls"] == 2,
            "partial_fit calls not counted")
    out["stream_randomized"] = agreement(
        r.singular_values_, r.components_, refs["ns_stream_sigma"],
        refs["ns_stream_components"])
    out["stream_exact_sigma_err_over_sigma1"] = agreement(
        e.singular_values_, e.components_, refs["ns_exact_sigma"],
        refs["ns_exact_components"])["sigma_err_over_sigma1"]
    out["partial_fit_vs_fit_batched"] = agreement(
        pf.singular_values_, pf.components_, e.singular_values_,
        e.components_)
    state += [r.singular_values_, r.components_, e.singular_values_,
              e.components_, pf.singular_values_, pf.components_]
    # The cost of gloo's staging through host memory: the stream fold's
    # gather of one 4096² float64 accumulator, and an all-reduce of it.
    acc = torch.ones((NS_D, NS_D), dtype=torch.float64, device=dev)
    with timed_collectives() as gather:
        pdist.all_gather(acc, mesh)
    with timed_collectives() as reduce:
        pdist.psum([acc], mesh)
    out["gloo_staging"] = {"bytes": acc.numel() * 8,
                           "all_gather_s": gather["seconds"],
                           "all_reduce_s": reduce["seconds"]}

    flat = torch.cat([t.detach().reshape(-1).double() for t in state])
    both = pdist.all_gather(flat, mesh)
    out["replicated_state_bitwise_equal"] = bool(torch.equal(both[0],
                                                             both[1]))
    out["launches"] = launches
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    emit({"multihost_child": out})
    # Leave the group together: a process that exits while its peer
    # still holds gloo connections to it can abort in the teardown.
    dist.barrier()
    dist.destroy_process_group()
    return 0


@phase
def phase_multihost(ctx):
    """Two processes of this script (``--multihost-child``) on the one
    card, a gloo group (NCCL refuses two ranks on one device) with two
    shards each: :func:`multihost_child`.  Gates, on both processes'
    results: replicated state bitwise equal; against the single-process
    fits of this run, the flagship's σ within 1e-5 and components within
    1e-4, the streams' σ within 1e-5·σ₁ (Gram grade, as
    ``stream_north_star`` holds the stream against the in-core fit), the
    lockstep ``partial_fit`` within 1e-5 of ``fit_batched``, FastIca at
    30 iterations within 1e-9 and its default fit's Amari distance
    within ``AMARI_MAX``.  Each process has a deadline; one that fails
    or outlives it fails the phase."""
    import os
    import tempfile

    import torch

    work = tempfile.mkdtemp(prefix="petal-multihost-")
    torch.save({"slice_sigma": ctx.slice_sigma.cpu(),
                "slice_components": ctx.slice_components.cpu(),
                "ns_stream_sigma": ctx.ns_stream_sigma.cpu(),
                "ns_stream_components": ctx.ns_stream_components.cpu(),
                "ns_exact_sigma": ctx.ns_exact_sigma.cpu(),
                "ns_exact_components": ctx.ns_exact_components.cpu(),
                "ica": ctx.ica_mesh_ref.cpu()},
               os.path.join(work, "refs.pt"))
    torch.cuda.empty_cache()
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--multihost-child",
         str(rank), str(port), work],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in (0, 1)]
    logs, codes = [], []
    try:
        deadline = time.monotonic() + MH_TIMEOUT_S
        for p in procs:
            log, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            logs.append(log)
            codes.append(p.returncode)
    except subprocess.TimeoutExpired:
        codes.append("timeout")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    tails = [log[-3000:] for log in logs]
    require(codes == [0, 0],
            f"multi-host processes exited {codes}:\n" + "\n----\n".join(tails))
    res = []
    for rank in (0, 1):
        with open(os.path.join(work, f"rank{rank}.json")) as f:
            res.append(json.load(f))
    for r in res:
        require(r["replicated_state_bitwise_equal"],
                "replicated state differs between the processes")
        ctx.add_launches(r["launches"])
    r0 = res[0]
    checks = {
        "flagship sigma": (r0["flagship"]["sigma_rel"], 1e-5),
        "flagship components": (r0["flagship"]["components_max_abs"], 1e-4),
        "stream randomized": (
            r0["stream_randomized"]["sigma_err_over_sigma1"], 1e-5),
        "stream exact": (r0["stream_exact_sigma_err_over_sigma1"], 1e-5),
        "partial_fit": (r0["partial_fit_vs_fit_batched"]["sigma_rel"], 1e-5),
        "fast_ica": (r0["fast_ica_components_rel"], 1e-9),
        "fast_ica defaults": (r0["fast_ica_defaults"]["amari_distance"],
                              AMARI_MAX),
    }
    for what, (got, band) in checks.items():
        require(got <= band, f"multi-host {what}: {got} > {band}")
    return {"phase": "multihost", "processes": 2, "backend": "gloo",
            "shards_per_process": 2, "wall_s": time.perf_counter() - t0,
            "ranks": res}


def k2_without_gate(k2):
    """A stand-in for ``k2.jacobi_svd_vmem`` without the JAX kernel's
    gate, under a block plan of the reach the kernel itself has (n_pad ≤
    632 and 4 MiB of panel and V): what :func:`phase_k2_reach` times
    past the gate.  It counts no launch."""
    import torch

    from petal_decomposition_tpu_torch.ops.kernels import jacobi_block

    wide = jacobi_block.BlockPlan(torch.float32, k2._MAX_N_PAD,
                                  k2._MAX_BYTES, k2._CYCLES)
    lib = k2.build()

    def run(a, *, max_sweeps=30):
        m, n = a.shape
        block_plan = wide.plan(m, n)
        return jacobi_block.launch(
            lib, lib.petal_jacobi_svd_f32, a, max_sweeps, block_plan,
            wide.threads(2 * block_plan[0], block_plan[3]), k2.EPS,
            k2._tol(m, n))

    return run


# Centered low-rank-plus-noise float32 panels at the edges of K2's reach,
# and the rung the ladder takes for each.
K2_EDGES = {(1333, 300): "k2", (3125, 128): "k2", (632, 632): "k2",
            (3000, 300): "qr_k2"}


def sigma_errors(s, s_ref):
    """``(all, top K)``: max |σ − σ_ref| relative to σ₁."""
    err = (s.double() - s_ref).abs() / s_ref[0]
    return float(err.max()), float(err[:K].max())


@phase
def phase_k2_reach(ctx):
    """K2's reach is the JAX kernel's gate, m·max(n_pad, 128) ≤ 400,000.

    At its edges (``K2_EDGES``, ``make_data`` panels) each panel's σ
    by the rung the ladder takes, against float64 relative to σ₁: the
    top K (what ``Pca(K)`` reports) within 1e-5, and the whole spectrum
    within 1e-5 on the tall panels.  The stop rule of the TPU kernel is
    norm-wise: it ends the sweeps once every pair's |apq| is within
    tol = eps·√max(m, n_pad) of σ₁², so two near-null columns of a
    square panel may stay coupled by up to tol·σ₁², and their σ off by
    up to √tol·σ₁; there (m < 2n) the whole spectrum is held to that.
    The TPU kernel's order (``_jacobi_svd_plain``) is read on the same
    panels beside it.

    Past the gate (5000×169, 3000×300 and 10000×16 centered Gaussian
    panels, column scales 1 to 5) the ladder takes QR + K2 on R, as the
    JAX package does; K2 on the panel itself (:func:`k2_without_gate`)
    is timed beside it (CUDA events, median of 20), each with σ against
    float64, and QR + K2 held to 1e-5."""
    import torch

    from petal_decomposition_tpu_torch.ops import jacobi

    k2, f32 = ctx.k2, torch.float32
    real_route, real_wrapper = jacobi._route, k2.jacobi_svd_vmem
    edges = {}
    for (m, n), rung in K2_EDGES.items():
        x = make_data(ctx.dev, m, n, f32, SEED + 14)
        a = x - x.mean(0)
        require(real_route(m, n, f32, "cuda") == rung,
                f"{m}x{n} float32 does not take {rung}")
        s_ref = torch.linalg.svdvals(a.double())
        row = dict(zip(("sigma_rel_err_f64", "top_k_sigma_rel_err_f64"),
                       sigma_errors(jacobi.jacobi_svd(a)[1], s_ref)),
                   rung=rung)
        if rung == "k2":
            a_rot, _, _ = k2._jacobi_svd_plain(a, 30)
            row["tpu_order_sigma_rel_err_f64"] = sigma_errors(
                torch.sqrt((a_rot * a_rot).sum(0)).sort(descending=True)[0],
                s_ref)[0]
        row["band"] = (1e-5 if m >= 2 * n
                       else max(1e-5, math.sqrt(k2._tol(m, n))))
        edges[f"{m}x{n}"] = row
    emit({"phase": "k2_reach_edges", "panels": edges})
    for name, row in edges.items():
        require(row["top_k_sigma_rel_err_f64"] <= 1e-5,
                f"{name} {row['rung']}: top-{K} σ error {row}")
        require(row["sigma_rel_err_f64"] <= row["band"],
                f"{name} {row['rung']}: σ error {row}")

    wide = k2_without_gate(k2)
    out = {}
    try:
        for m, n in ((5000, 169), (3000, 300), (10_000, 16)):
            g = torch.Generator(device=ctx.dev)
            g.manual_seed(SEED + 13)
            x = (torch.randn(m, n, generator=g, device=ctx.dev)
                 * torch.linspace(1, 5, n, device=ctx.dev))
            a = x - x.mean(0)
            require(real_route(m, n, f32, "cuda") == "qr_k2",
                    f"{m}x{n} float32 does not take the JAX gate's rung")
            s_ref = torch.linalg.svdvals(a.double())
            row = {}
            for route in ("k2", "qr_k2"):
                jacobi._route = lambda *_args, route=route: route
                k2.jacobi_svd_vmem = wide if route == "k2" else real_wrapper
                err = sigma_errors(jacobi.jacobi_svd(a)[1], s_ref)[0]
                require(math.isfinite(err), f"{m}x{n} {route}: σ not finite")
                row[route] = {"ms": cuda_ms(lambda: jacobi.jacobi_svd(a), 20),
                              "sigma_rel_err_f64": err}
            require(row["qr_k2"]["sigma_rel_err_f64"] <= 1e-5,
                    f"{m}x{n} qr_k2: σ error {row['qr_k2']}")
            out[f"{m}x{n}"] = row
    finally:
        jacobi._route, k2.jacobi_svd_vmem = real_route, real_wrapper
    return {"phase": "k2_reach", "edges": edges, "past_gate": out}


# The panels K2 is timed on; the PyTorch call for each is the SVD.
K2_TIMED = ("bt_1024x43", "r_factor_64x64", "config1_f32_1000x64",
            "r_factor_256x256", "r_factor_632x632",
            "fast_ica_r_factor_64x64")


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
    "fast_ica_gram_64x64": "eigh",
    "fast_ica_decorrelation_64x64": "eigh",
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
          phase_randomized_complex, phase_serialize, phase_native_offload,
          phase_nan_debugging, phase_fast_ica_config3, phase_fast_ica_card_vs_cpu,
          phase_k4, phase_k6, phase_k5,
          phase_stream_north_star, phase_stream_exact,
          phase_stream_randomized_f64, phase_partial_fit,
          phase_stream_fast_ica, phase_mesh_one_card, phase_mesh_shards,
          phase_multihost, phase_k2_reach, phase_k2, phase_k3)

KERNELS = {
    "sketch_moments": ("sketch_moments.cu", "sketch_kernel.py:143"),
    "jacobi_svd": ("jacobi_svd.cu", "jacobi_kernels.py:187"),
    "jacobi_svd_f64": ("jacobi_svd_f64.cu", "jacobi_f64_kernel.py:187"),
    "ica_update": ("ica_update.cu", "none (XLA ops in the JAX package's "
                   "while_loop)"),
    "gram_syrk": ("gram_syrk.cu", "none (the Gram finder's XᵀX, an XLA "
                  "product in the JAX package)"),
    "ica_sums": ("ica_sums.cu", "none (XLA ops in the JAX package's "
                 "while_loop)"),
}


def context():
    """Import the port, build its kernels in parallel and print the
    device line; the state the phases share."""
    import torch

    import petal_decomposition_tpu_torch as api
    from petal_decomposition_tpu_torch.ops import linalg
    from petal_decomposition_tpu_torch.ops.kernels import (
        gram_syrk as k5,
        ica_sums as k6,
        ica_update as k4,
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
    with ThreadPoolExecutor(6) as pool:
        for done in [pool.submit(m.build) for m in (k1, k2, k3, k4, k5, k6)]:
            done.result()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "kernel_build_s": time.perf_counter() - t0})
    ctx = SimpleNamespace(
        api=api, linalg=linalg, k1=k1, k2=k2, k3=k3, k4=k4, k5=k5, k6=k6,
        smi=smi,
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
            "replaces": (replaces if replaces.startswith("none")
                         else f"petal_decomposition_tpu/ops/pallas/{replaces}"),
            "launches": k["launches"], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"],
            "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
            "library_ms": k["library_ms"],
        })
    return {"kernels": out}


def main() -> int:
    import torch

    if len(sys.argv) == 5 and sys.argv[1] == "--multihost-child":
        return multihost_child(int(sys.argv[2]), int(sys.argv[3]),
                               sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import petal_decomposition_tpu_torch  # noqa: F401
    except ModuleNotFoundError as e:
        if e.name != "petal_decomposition_tpu_torch":
            raise
        print("chip_smoke: the package petal_decomposition_tpu_torch is "
              "not beside this script; run it from a checkout of the "
              "repository", file=sys.stderr)
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
