"""K5's share of its roofline: the bound of the traced forward attention
calls (q, k, v, o once; 4·hd operations a kept pair) over K5's device
time."""

from benchmark.readlib import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flash_fwd_work", "flash_fwd_kernels")
