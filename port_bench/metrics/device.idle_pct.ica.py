"""``device.idle_pct`` of a FastICA cell, where it moves ``fit_ms.ica``."""

from port_bench.core.readers import idle_pct as value  # noqa: F401
