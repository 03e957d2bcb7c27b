"""``FastIca``: its data, its model, what each fit leaves to compare and
the comparison that decides ``correct``.

The data is ``sources`` independent Laplace(0, 1) signals of ``n``
samples mixed by A = Q₁·diag(linspace(1, cond))·Q₂ᵀ, Q₁ and Q₂ random
orthogonal, made on the device from the seed (the mixing first, then the
sources in blocks of ``gen_rows`` rows).

FastICA's answer has no canonical order or sign, and each fit starts
from its own W₀, so each fit is judged by what it says, against the
plain reference (``reference/fast_ica.py``) at float64: its unmixing
rows must be a fixed point of the reference's update in the reference's
whitening (``fixed_point``), and its mean the data's (``mean``).  The
last fit's ``mixing_`` is held to the float64 pseudo-inverse of its own
components, and its ``transform`` of the data to (X − μ)·Cᵀ at float64.
"""

from __future__ import annotations

import torch

from ..reference import common as refc
from ..reference import fast_ica as ref
from .common import by_data, checks_from, rel_max


def row_blocks(cfg: dict, seed: int, device):
    data = cfg["data"]
    n, k = int(data["n"]), int(data["sources"])
    rows = int(data["gen_rows"])
    dt = getattr(torch, data["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    q1, q2 = (torch.linalg.qr(torch.randn(k, k, generator=g, device=device,
                                          dtype=dt)).Q for _ in range(2))
    with refc.no_tf32():
        a = (q1 * torch.linspace(1, float(data["cond"]), k, device=device,
                                 dtype=dt)) @ q2.mT
        for i in range(0, n, rows):
            b = min(rows, n - i)
            e = torch.empty((2, b, k), dtype=dt, device=device).exponential_(
                generator=g)
            yield (e[0] - e[1]) @ a.mT


def build_model(cfg: dict, seed: int, device):
    from petal_decomposition_tpu_torch import FastIca

    knobs = {k: v for k, v in cfg["model"].items() if k != "class"}
    return FastIca(seed=int(seed), device=device, **knobs)


def snapshot(model) -> dict:
    return {"components": model.components_, "mean": model.mean_}


def final(model, inputs) -> dict:
    """The last fit's ``mixing_`` and its ``transform`` of its own data."""
    return {"mixing": model.mixing_, "transform": model.transform(inputs.arg)}


def _k(cfg) -> int:
    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    return int(cfg["model"].get("n_components") or min(n, d))


def _data(inputs, c) -> torch.Tensor:
    return torch.cat(list(inputs.row_blocks(c)))


def gaps(x, wh, snaps, last) -> dict:
    """The worst gap of each number over ``snaps``, fits that all saw
    ``x``; ``last`` (``mixing_`` and ``transform``) belongs to the last
    of them, or is empty."""
    out = {"fixed_point": 0.0, "mean": 0.0}
    scale = float(wh.col_std.max())
    for _, s in snaps:
        out["fixed_point"] = max(out["fixed_point"],
                                 ref.fixed_point_residual(s["components"], wh))
        out["mean"] = max(out["mean"], rel_max(s["mean"], wh.mean, scale))
    if last:
        c = snaps[-1][1]["components"].double()
        with refc.no_tf32():
            pinv = torch.linalg.pinv(c)
            want = (x.double() - wh.mean) @ c.mT
        out["mixing"] = rel_max(last["mixing"], pinv, pinv.abs().max())
        out["transform"] = rel_max(last["transform"], want, want.abs().max())
    return out


def judge(cfg, traffic, seed, inputs, snaps, last, limits, device) -> list:
    """``[(name, value, limit)]``: the worst of each number over every fit
    of the window, each against the whitening of the data it saw (the
    last fit's for ``mixing`` and ``transform``)."""
    k = _k(cfg)
    snap_of = dict(snaps)
    final_fit = snaps[-1][0]
    acc: dict = {}
    for group in by_data(inputs, [i for i, _ in snaps]).values():
        x = _data(inputs, group[0])
        wh = ref.whiten(x, k, "float64")
        mine = [(i, snap_of[i]) for i in group]
        for name, v in gaps(x, wh, mine,
                            last if group[-1] == final_fit else {}).items():
            acc[name] = max(acc.get(name, 0.0), v)
        del x, wh
    return checks_from(acc, limits)


def control(cfg, traffic, seed, inputs, fits, precision):
    """The reference at ``precision`` in the program's place, from a W₀
    drawn from ``seed``, on the data of the first of ``fits``: one fit's
    snapshot and its ``final``."""
    c = fits[0]
    x = _data(inputs, c)
    k = _k(cfg)
    m = cfg["model"]
    w0 = torch.randn((k, k), generator=torch.Generator().manual_seed(int(seed)),
                     dtype=torch.float64)
    comps, mean, _ = ref.fit(x, w0, k, int(m.get("max_iter", 200)),
                             float(m.get("tol", 1e-4)), precision)
    dt = refc.dtype_of(precision)
    with refc.no_tf32():
        last = {"mixing": ref.pseudo_inverse(comps, precision),
                "transform": refc.mm(x.to(dt) - mean, comps.mT, precision)}
    return [(c, {"components": comps, "mean": mean})], last
