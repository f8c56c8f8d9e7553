"""Device milliseconds a batch of the encoder's attention: the kernels
launched inside the program's ``ts.encoder.attention`` spans (QKV, then
K5, SDPA or the reference attention), every layer summed."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx.get("reading"), "ts.encoder.attention")
