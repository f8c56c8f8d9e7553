"""The whole step's share of the card's bf16 peak: the useful operations
the cell counts for its window (its driver's ``useful_flops``) over the
window's wall."""

from benchmark.readlib import mfu_pct


def read(ctx):
    return mfu_pct(ctx)
