"""What the per-layer readers share. A reader returns None where its run
recorded nothing to read (no traced stretch, no device time, no launch of
its kernel); a share is never read as 0 in its place."""

from __future__ import annotations

from typing import Optional

from . import flops


def idle_pct(ctx: dict) -> Optional[float]:
    """The device's idle share: 1 − (busy seconds a unit in the traced
    stretch, the union of its device intervals) ÷ (wall seconds a unit in
    the unprofiled window)."""
    r, win = ctx.get("reading"), ctx.get("window")
    if r is None or r.units == 0 or win is None or win.units == 0:
        return None
    busy = r.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - (busy / r.units) / (win.wall_s / win.units))


def roofline_pct(ctx: dict, work: str, kernels: str) -> Optional[float]:
    """The least time the traced calls' work needs on the card ÷ the
    device time their kernels took, in %."""
    r = ctx.get("reading")
    if r is None or not ctx.get(work):
        return None
    t, n = r.kernel_s(ctx[kernels])
    if n == 0 or t <= 0:
        return None
    return 100.0 * sum(flops.bound_s(b, o) for b, o in ctx[work]) / t


def mfu_pct(ctx: dict) -> Optional[float]:
    """Useful operations of the unprofiled window ÷ (its wall × the bf16
    peak), in %."""
    win = ctx.get("window")
    if win is None or win.wall_s <= 0 or not ctx.get("useful_flops"):
        return None
    return 100.0 * ctx["useful_flops"] / (win.wall_s * flops.PEAK_BF16)
