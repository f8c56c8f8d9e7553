"""Device milliseconds a request of the probe plan: the kernels launched
inside the program's ``ts.ivf.plan`` span (normalize, the centroid GEMM,
argmax, the two sorts, the union)."""

from benchmark.spans import device_ms


def read(ctx):
    return device_ms(ctx.get("reading"), "ts.ivf.plan")
