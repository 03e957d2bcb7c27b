"""``torch.cuda.max_memory_allocated()`` over the window, reset after
set-up, in GiB: the cell's inputs held on the card and what the fits
allocate beside them."""


def value(run):
    if run.device.type != "cuda":
        return None
    return run.peak_bytes / 2 ** 30
