"""The traced fits' streamed bytes over the summed device time of the
profiler's host-to-device copies in them, in GB/s: the rate of the feed's
copies to the card while they run."""


def value(run):
    s = run.summary
    if s is None or not run.traced_fits:
        return None
    copies = s.copies("HtoD")
    secs = sum(e.dur for e in copies)
    if secs <= 0:
        return None
    itemsize = run.inputs.arg[0].itemsize
    nbytes = len(run.traced_fits) * run.inputs.n * run.inputs.d * itemsize
    return nbytes / secs / 1e9
