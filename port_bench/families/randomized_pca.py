"""``RandomizedPca``: its data, its model, what each fit leaves to
compare and the comparison that decides ``correct``.

The data is a low-rank signal plus noise with a non-zero mean (the
configuration's ``data``): ``rank`` directions with σⱼ ∝ sigma0·decayʲ
on a random orthonormal basis, Gaussian noise, and a Gaussian mean, made
on the device from the seed in blocks of ``gen_rows`` rows.

Each compared fit of the window is judged against the plain reference
(``reference/randomized_pca.py``) at float64 on the data that fit saw,
run with the test matrix that fit drew (the models' seed contract,
``reference/common.py``): singular values, mean and explained variance
ratio against the reference's; each component by its eigen-residual in
the reference's centered Gram with the fit's own σ (an error that does
not grow as two singular values draw close, as a componentwise gap does);
and the components' signs.  The sign rule is the entry's: ``fit`` pivots
on U, ``fit_batched`` on the components.  Where the reference's pivot
ties its runner-up within ``PIVOT_TIE`` (relative), either sign is
right.
"""

from __future__ import annotations

import torch

from ..reference import common as refc
from ..reference import randomized_pca as ref
from .common import by_data, checks_from, rel_max, sample

SIGNS = {"fit": "u_pivot", "fit_batched": "v_pivot"}
PIVOT_TIE = 1e-3


def row_blocks(cfg: dict, seed: int, device):
    data = cfg["data"]
    n, d, r = int(data["n"]), int(data["d"]), int(data["rank"])
    rows = int(data["gen_rows"])
    dt = getattr(torch, data["dtype"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    basis = torch.linalg.qr(
        torch.randn(d, r, generator=g, device=device, dtype=dt)).Q.mT
    scale = float(data["sigma0"]) * float(data["decay"]) ** torch.arange(
        r, device=device, dtype=dt)
    mean = float(data["mean_std"]) * torch.randn(d, generator=g,
                                                 device=device, dtype=dt)
    with refc.no_tf32():
        for i in range(0, n, rows):
            b = min(rows, n - i)
            x = float(data["noise"]) * torch.randn(b, d, generator=g,
                                                   device=device, dtype=dt)
            x.addmm_(torch.randn(b, r, generator=g, device=device, dtype=dt)
                     * scale, basis)
            x += mean
            yield x


def build_model(cfg: dict, seed: int, device):
    from petal_decomposition_tpu_torch import RandomizedPca

    knobs = {k: v for k, v in cfg["model"].items()
             if k not in ("class", "n_components")}
    return RandomizedPca(int(cfg["model"]["n_components"]), seed=int(seed),
                         device=device, **knobs)


def snapshot(model) -> dict:
    return {"sigma": model.singular_values_,
            "components": model.components_,
            "mean": model.mean_,
            "evr": model.explained_variance_ratio_}


def final(model, inputs) -> dict:
    return {}


def _shape(cfg):
    n, d = int(cfg["data"]["n"]), int(cfg["data"]["d"])
    m = cfg["model"]
    k = int(m["n_components"])
    return d, k, min(k + int(m.get("n_oversamples", 10)), n, d), int(
        m.get("n_power_iters", 7))


def reference(cfg, traffic, seed, inputs, fits, precision) -> dict:
    """``{fit: Solution}`` of the reference at ``precision`` for the
    numbered fits of a model seeded with ``seed``, each on the data that
    fit saw (one pass over the rows for each distinct data)."""
    d, k, l, q = _shape(cfg)
    omegas = refc.fit_draws(seed, fits, (d, l),
                            getattr(torch, cfg["data"]["dtype"]))
    out = {}
    for group in by_data(inputs, fits).values():
        out.update(ref.solve(lambda c=group[0]: inputs.row_blocks(c),
                             {i: omegas[i] for i in group}, k, q,
                             SIGNS[traffic["entry"]], precision))
    return out


def gaps(out: dict, want: ref.Solution) -> dict:
    """The fit's numbers against the reference's.  ``components``: the
    largest eigen-residual of a component in the reference's Gram, over
    σ₁² (its length checked too); ``signs``: the components whose sign
    differs from the reference's where its pivot is decided."""
    comps = out["components"].double()
    wc = want.components.double()
    decided = want.pivot_gap >= PIVOT_TIE
    flipped = (comps * wc).sum(1) < 0
    s1 = float(want.sigma[0])
    return {
        "sigma": rel_max(out["sigma"], want.sigma, want.sigma[0]),
        "components": float(ref.eigen_residual(comps, out["sigma"].double(),
                                               want.gram, s1 * s1).max()),
        "signs": float((flipped & decided).sum()),
        "mean": rel_max(out["mean"], want.mean, want.mean.abs().max()),
        "evr": rel_max(out["evr"], want.evr, want.evr[0]),
    }


def worst(snaps, sols) -> dict:
    acc: dict = {}
    for i, out in snaps:
        for name, v in gaps(out, sols[i]).items():
            acc[name] = max(acc.get(name, 0.0), v)
    return acc


def judge(cfg, traffic, seed, inputs, snaps, last, limits,
          device) -> list:
    """``[(name, value, limit)]``: the worst gap of each number over the
    compared fits."""
    picked = sample([i for i, _ in snaps], int(traffic["check_fits"]), seed)
    chosen = [(i, out) for i, out in snaps if i in set(picked)]
    sols = reference(cfg, traffic, seed, inputs, picked, "float64")
    return checks_from(worst(chosen, sols), limits)


def control(cfg, traffic, seed, inputs, fits, precision):
    """The reference at ``precision`` in the program's place: the same
    snapshots the program's fits would leave, and an empty ``final``."""
    sols = reference(cfg, traffic, seed, inputs, fits, precision)
    return [(i, {"sigma": s.sigma, "components": s.components,
                 "mean": s.mean, "evr": s.evr}) for i, s in sols.items()], {}
