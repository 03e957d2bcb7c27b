"""``RandomizedPca`` on a mesh of processes, each holding its own rows
(``parallel.rows_from_local``): the data, the snapshots, the reference
and the comparison are ``randomized_pca``'s, since a sharded fit must
give the whole matrix's answers; the model adds the mesh of every
process's cards, and the comparison adds the placement's check that every
process holds the rows a whole-matrix generation puts there."""

from __future__ import annotations

from . import randomized_pca as base
from .randomized_pca import control, final, row_blocks, snapshot  # noqa: F401

SHARDS = "shards"


def build_model(cfg: dict, seed: int, device):
    from petal_decomposition_tpu_torch import RandomizedPca
    from petal_decomposition_tpu_torch.parallel import make_mesh

    knobs = {k: v for k, v in cfg["model"].items()
             if k not in ("class", "n_components")}
    return RandomizedPca(int(cfg["model"]["n_components"]), seed=int(seed),
                         mesh=make_mesh(), **knobs)


def judge(cfg, traffic, seed, inputs, snaps, last, limits, device) -> list:
    """``randomized_pca``'s checks, with ``shards``: the number of
    processes whose rows differ from rank 0's regeneration of them
    (``placements/local_rows.py``), an exact count."""
    checks = base.judge(cfg, traffic, seed, inputs, snaps, last,
                        {k: v for k, v in limits.items() if k != SHARDS},
                        device)
    if SHARDS in limits:
        checks.append((SHARDS, float(inputs.shard_mismatch),
                       float(limits[SHARDS])))
    return checks
