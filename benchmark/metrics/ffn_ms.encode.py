"""Device milliseconds a batch of the rest of the encoder's blocks: the
kernels launched inside the program's ``ts.encoder.ffn`` spans (output
projection, residual + LN, FFN, residual + LN), every layer summed."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx.get("reading"), "ts.encoder.ffn")
