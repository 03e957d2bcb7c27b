"""The 90th percentile of all the window's fit times, in ms
(``statistics.quantiles``, exclusive method); none under ten fits."""

from port_bench.core.readers import p90_fit_ms as value  # noqa: F401
