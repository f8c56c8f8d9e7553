"""Device milliseconds a step of the kernels launched inside the
optimizer's range (clip + AdamW) in the traced stretch."""


def read(ctx):
    r = ctx.get("reading")
    name = ctx.get("optimizer_range")
    if r is None or not name or r.units == 0:
        return None
    t = r.range_device_s(name)
    return None if not t else 1e3 * t / r.units
