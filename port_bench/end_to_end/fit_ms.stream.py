"""``fit_ms`` of a streamed cell, apart: the host's copies into pinned
memory spread it from run to run by about twenty times what the in-core
north star does, so it has its own bound."""

from port_bench.core.readers import mean_fit_ms as value  # noqa: F401
