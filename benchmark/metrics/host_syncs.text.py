"""Host syncs a request: the CUDA runtime calls that wait for the card
(stream, device and event synchronizations, blocking copies) starting
inside the program's ``ts.search`` span."""

from benchmark.spans import SYNC_CALLS, calls_in


def read(ctx):
    return calls_in(ctx.get("reading"), "ts.search", SYNC_CALLS)
