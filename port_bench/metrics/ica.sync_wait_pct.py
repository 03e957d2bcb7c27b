"""The host time blocked in the program's ``petal.ica.lim_read`` spans
(each step's ``float(lim)``, which waits for the card to finish the
step) over the host time inside its ``petal.ica.iterate`` spans, traced
fits, in %: how far the card lags the host (``core/spans.py``)."""

from port_bench.core import spans


def value(run):
    sp = spans.of_run(run)
    if sp is None:
        return None
    loop = spans.host_s(sp, "petal.ica.iterate")
    if loop <= 0:
        return None
    return 100.0 * spans.host_s(sp, "petal.ica.lim_read") / loop
