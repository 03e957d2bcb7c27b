"""The window's total fit time over the fits it completed, in ms: each
fit by the host clock from its call to its return and a synchronize."""

from port_bench.core.readers import mean_fit_ms as value  # noqa: F401
