"""``fit_ms`` of a FastICA cell, apart: its host loop spreads from run to
run by about forty times what the in-core north star does, so it has its
own bound."""

from port_bench.core.readers import mean_fit_ms as value  # noqa: F401
