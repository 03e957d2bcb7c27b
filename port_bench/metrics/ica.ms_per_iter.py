"""The window's summed fit time over its fits' summed ``n_iter_``, in ms:
the time of one step of the host loop, whitening shared out."""


def value(run):
    its = sum(f.n_iter or 0 for f in run.fits)
    if its == 0:
        return None
    return sum(f.ms for f in run.fits) / its
