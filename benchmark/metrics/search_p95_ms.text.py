"""The 95th percentile of every request's latency in the window (host
clock, each request ends with its rows on the host). A per-layer reading:
a request of a few tens of milliseconds is too short for the host clock to
bound."""


def read(ctx):
    win = ctx.get("window")
    return None if win is None or win.units == 0 else win.p95_ms()
