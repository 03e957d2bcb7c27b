"""The in-core moments pass's least time over its device time inside the
timed fit, in %.

The pass is the program's ``petal.rpca.moments`` span (all of
``parallel/distributed.py::_gram_moments``: column means, total
variance, the IEEE-float32 Gram and the guard's read).  Its device time
is the union of the kernels launched inside that span in the traced
fits (``core/spans.py``), over the number of such spans: one a fit.  Its
least time is as ``gram_pass.roofline_pct``'s: the larger of X's bytes
read once at the card's memory rate and n·d·(d + 1) + 3·n·d operations
at its float32 peak (``counts/randomized_pca.py``).  None where the
trace holds no such kernel (no card, or a program without the span)."""

from port_bench.core import spans


def value(run):
    sp = spans.of_run(run)
    x = run.inputs.arg
    if sp is None or run.peaks is None or not hasattr(x, "shape"):
        return None
    kernels = spans.kernels_by_span(sp).get("petal.rpca.moments")
    fits = spans.count(sp, "petal.rpca.moments")
    if not kernels or fits == 0:
        return None
    secs = spans.device_s(kernels) / fits
    n, d = x.shape
    ops = run.counts.gram_pass_ops(n, d)
    nbytes = run.counts.gram_pass_bytes(n, d, x.element_size())
    least = max(ops / run.peaks["flop_s"][run.cfg["data"]["dtype"]],
                nbytes / run.peaks["hbm_bytes_s"])
    return 100.0 * least / secs
