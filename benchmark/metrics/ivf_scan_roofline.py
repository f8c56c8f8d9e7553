"""K1's share of its roofline: the bound of the traced IVF calls' scans
(probed slabs' rows and ids, queries and top-k once) over the device time
of K1's kernels (the wgmma tile and its merge)."""

from benchmark.readlib import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "scan_work", "scan_kernels")
