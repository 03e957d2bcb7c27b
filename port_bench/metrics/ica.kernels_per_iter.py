"""The device kernels of the traced fits over their summed ``n_iter_``:
launches a step (the whitening shared out).  The count repeats exactly; a
step captured as a CUDA graph or fused moves it."""


def value(run):
    s = run.summary
    its = sum(f.n_iter or 0 for f in run.traced_fits)
    if s is None or its == 0 or not s.kernels():
        return None
    return len(s.kernels()) / its
