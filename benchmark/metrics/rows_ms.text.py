"""Host milliseconds a request inside the program's ``ts.search.rows``
span: the id remap and the result tuples built on the host."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx.get("reading"), "ts.search.rows")
