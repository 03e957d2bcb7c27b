"""``fit.mfu_pct`` of a streamed cell, where it moves ``fit_ms.stream``."""

from port_bench.core.readers import mfu_pct as value  # noqa: F401
