"""The in-core moments pass's least time over its device time, in %.

The pass is ``parallel/distributed.py::_gram_moments`` on the cell's X
(column means, total variance, the IEEE-float32 Gram), called here once
to warm and then timed by CUDA events over three calls, after the
window.  Its least time is the larger of X's bytes read once at the
card's memory rate and n·d·(d + 1) + 3·n·d operations at its float32 peak
(``counts/randomized_pca.py``).  A renamed entry in the program is a
repair of this file alone."""

REPS = 3


def value(run):
    torch = run.torch
    x = run.inputs.arg
    if run.peaks is None or not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        return None
    from petal_decomposition_tpu_torch.parallel import distributed as dist

    n, d = x.shape

    def call():
        return dist._gram_moments(dist.as_rows(x), True, True, "default", n)

    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    stop.record()
    torch.cuda.synchronize()
    secs = start.elapsed_time(stop) / 1e3 / REPS
    ops = run.counts.gram_pass_ops(n, d)
    nbytes = run.counts.gram_pass_bytes(n, d, x.element_size())
    least = max(ops / run.peaks["flop_s"][str(x.dtype).split(".")[1]],
                nbytes / run.peaks["hbm_bytes_s"])
    return 100.0 * least / secs
