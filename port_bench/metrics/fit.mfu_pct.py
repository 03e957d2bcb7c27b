"""The whole fit's share of the card's peak, in % (``core/readers.py``)."""

from port_bench.core.readers import mfu_pct as value  # noqa: F401
