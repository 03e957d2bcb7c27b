"""What the families share: the sample of fits a run compares, and the
gaps it compares them by."""

from __future__ import annotations

import random


def sample(indices: list, most: int, seed: int) -> list:
    """At most ``most`` of ``indices``, drawn from ``seed``, always with
    the last."""
    if len(indices) <= most:
        return list(indices)
    rest = random.Random(seed).sample(indices[:-1], most - 1)
    return sorted(rest) + [indices[-1]]


def by_data(inputs, fits) -> dict:
    """The fits grouped by the data they saw: ``{key: [fit, ...]}``, in
    the fits' order."""
    groups: dict = {}
    for i in fits:
        groups.setdefault(inputs.key(i), []).append(i)
    return groups


def rel_max(got, want, scale) -> float:
    """max |got − want| over ``scale``, in float64."""
    return float((got.double() - want.double()).abs().max() / scale)


def checks_from(gaps: dict, limits: dict) -> list:
    """``[(name, value, limit)]`` in the limits file's order; a number the
    run could not read counts as failed (inf)."""
    return [(name, float(gaps.get(name, float("inf"))), float(lim))
            for name, lim in limits.items() if not name.startswith("_")]
