"""The whole fit's share of the cards' peak, in %: the whole matrix's
operations for the window's fits (``counts/<family>.py``) over their
summed time times the cell's cards times one card's float32 peak."""

from port_bench.core.readers import mfu_pct


def value(run):
    share = mfu_pct(run)
    return None if share is None else share / run.cell.chips
