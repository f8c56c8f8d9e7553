"""The device's idle share of the cell's steady loop (traced stretch's
busy union against the unprofiled window's wall, a unit each)."""

from benchmark.readlib import idle_pct


def read(ctx):
    return idle_pct(ctx)
