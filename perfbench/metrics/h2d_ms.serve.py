"""Device milliseconds of host-to-device copies per served batch in the
traced stretch (the frames' upload)."""


def read(ctx):
    if ctx.device.type != "cuda":
        return None
    return 1e3 * ctx.trace_data.copy_s("HtoD") / ctx.traced_units["batches"]
