"""Device kernel launches per training step in the traced stretch."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return ctx.trace_data.kernels() / ctx.traced_units["steps"]
