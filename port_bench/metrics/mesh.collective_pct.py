"""The share of the traced fits' time in which rank 0's card ran the
mesh's collectives, in %: the union of the kernels launched under the
program's ``petal.mesh.*`` spans (``parallel/distributed.py``: each
all-reduce and all-gather, NCCL's kernels under the innermost span that
launched them, ``core/spans.py``) over the traced fits' summed time.  A
collective's kernel runs until the last rank joins it, so the share holds
the ranks' skew too.  None where the trace holds no such kernel (no card,
or a program without the spans)."""

from port_bench.core import spans

PREFIX = "petal.mesh."


def value(run):
    sp = spans.of_run(run)
    if sp is None or not run.traced_fits:
        return None
    kernels = [iv for name, ivs in spans.kernels_by_span(sp).items()
               if name.startswith(PREFIX) for iv in ivs]
    if not kernels:
        return None
    fit_s = sum(f.ms for f in run.traced_fits) / 1e3
    return 100.0 * spans.device_s(kernels) / fit_s
