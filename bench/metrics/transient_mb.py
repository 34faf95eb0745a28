"""Device memory a step takes above what was in use when it began, at
its highest (temporaries and new outputs before the old ones are
freed), from the device allocator's events in the trace; the median
over the traced steps."""


def read(ctx):
    if ctx.trace is None:
        return None
    b = ctx.trace.transient_bytes()
    return None if b is None else b / 1e6
