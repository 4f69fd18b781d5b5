"""The device's idle share of the traced serving stretch, in percent:
1 - (union of kernels, copies and fills on every stream) / the stretch's
wall time."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return 100.0 * ctx.trace_data.idle_share()
