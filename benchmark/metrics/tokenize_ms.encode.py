"""Host milliseconds a batch inside the program's ``ts.tokenize`` span:
the native WordPiece batch and the token-id rows of the documents."""

from benchmark.spans import host_ms


def read(ctx):
    return host_ms(ctx.get("reading"), "ts.tokenize")
