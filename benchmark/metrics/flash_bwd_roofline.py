"""K6's share of its roofline: the bound of the traced backward attention
calls (8 tensors once; 10·hd operations a kept pair) over the device time
of K6's two kernels."""

from benchmark.readlib import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "flash_bwd_work", "flash_bwd_kernels")
