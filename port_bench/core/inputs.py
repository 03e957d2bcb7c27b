"""What each fit is given: the configuration's rows, placed as the
traffic says (``placements/<name>.py``), with one block of rows rescaled
fit by fit.

The traffic's ``vary`` splits the rows into ``blocks`` equal parts, and
the seed picks one of them; fit number ``c`` (warm-up fits counted) finds
that block multiplied by ``factors[c % len(factors)]``.  The factors are
powers of two, so every fit's data is exact and known, and consecutive
fits see different data: a fit that returns at once, leaving the previous
fit's state, reads wrong.  The rescaling is done before a fit's timer
starts.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass


@dataclass(frozen=True)
class Vary:
    lo: int  # the rescaled rows: [lo, hi)
    hi: int
    factors: tuple

    def factor(self, c: int) -> float:
        return self.factors[c % len(self.factors)]

    def overlap(self, start: int, stop: int):
        """The rescaled rows of ``[start, stop)``, relative to ``start``,
        or ``None``."""
        a, b = max(self.lo, start), min(self.hi, stop)
        return (a - start, b - start) if a < b else None


def vary_of(traffic: dict, n: int, seed: int) -> Vary:
    v = traffic["vary"]
    blocks = int(v["blocks"])
    factors = tuple(float(f) for f in v["factors"])
    if len(set(factors)) < 2 or any(math.frexp(f)[0] != 0.5 for f in factors):
        raise ValueError(f"vary factors {factors}: two or more distinct "
                         "powers of two")
    j = random.Random(int(seed)).randrange(blocks)
    return Vary(j * n // blocks, (j + 1) * n // blocks, factors)


class Inputs:
    """A placement's rows.  ``prepare(c)`` makes fit ``c``'s data and
    returns the entry's argument (also kept as ``arg``);
    ``row_blocks(c)`` is a fresh iterator over fit ``c``'s rows as device
    tensors, in row order, for the reference; ``key(c)`` is equal for
    fits that saw equal data."""

    n: int
    d: int
    itemsize: int
    vary: Vary
    arg: object = None

    def key(self, c: int) -> float:
        return self.vary.factor(c)

    def prepare(self, c: int):
        raise NotImplementedError

    def row_blocks(self, c: int):
        raise NotImplementedError
