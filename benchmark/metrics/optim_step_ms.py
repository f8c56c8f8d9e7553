"""Device milliseconds a step of the kernels launched inside the
program's ``ts.train.optimizer`` span (global-norm clip + AdamW)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx.get("reading"), "ts.train.optimizer")
