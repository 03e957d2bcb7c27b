"""The moments pass's least time on one card's rows over its device time
inside the timed fit, in %, on rank 0's card.

As ``moments.roofline_pct``, at one shard's rows: the pass is the
program's ``petal.rpca.moments`` span, its device time the union of the
kernels launched inside it in the traced fits (the collectives' kernels
fall under their own ``petal.mesh.*`` spans and are not counted) over the
number of such spans; its least time is the larger of one shard's bytes
read once at the card's memory rate and its n_s·d·(d + 1) + 3·n_s·d
operations at the card's float32 peak, n_s = n / cards.  None where the
trace holds no such kernel."""

from port_bench.core import spans


def value(run):
    sp = spans.of_run(run)
    if sp is None or run.peaks is None:
        return None
    kernels = spans.kernels_by_span(sp).get("petal.rpca.moments")
    fits = spans.count(sp, "petal.rpca.moments")
    if not kernels or fits == 0:
        return None
    secs = spans.device_s(kernels) / fits
    n, d = int(run.cfg["data"]["n"]) // run.cell.chips, int(run.cfg["data"]["d"])
    ops = run.counts.gram_pass_ops(n, d)
    nbytes = run.counts.gram_pass_bytes(n, d, run.inputs.itemsize)
    least = max(ops / run.peaks["flop_s"][run.cfg["data"]["dtype"]],
                nbytes / run.peaks["hbm_bytes_s"])
    return 100.0 * least / secs
