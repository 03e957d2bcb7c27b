"""The host time inside the program's ``petal.ica.decorrelate`` spans
(the Newton–Schulz or eigh decorrelation of each step) over the host
time inside its ``petal.ica.iterate`` spans, traced fits, in %: the
share of the host loop the decorrelation holds (``core/spans.py``)."""

from port_bench.core import spans


def value(run):
    sp = spans.of_run(run)
    if sp is None:
        return None
    loop = spans.host_s(sp, "petal.ica.iterate")
    if loop <= 0:
        return None
    return 100.0 * spans.host_s(sp, "petal.ica.decorrelate") / loop
