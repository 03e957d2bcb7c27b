"""Rank 0's card's idle share over the traced fits, in %
(``core/readers.py``): the card of the process that times the fits."""

from port_bench.core.readers import idle_pct as value  # noqa: F401
