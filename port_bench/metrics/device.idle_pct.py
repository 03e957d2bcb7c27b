"""The card's idle share over the traced fits, in % (``core/readers.py``)."""

from port_bench.core.readers import idle_pct as value  # noqa: F401
