"""Process start to the first timed fit, in s: imports, the kernels
loaded (built in a checkout's first run), the inputs made from the seed
and placed, and the warm-up fits."""


def value(run):
    return run.setup_s
