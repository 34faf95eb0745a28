"""Share of the traced window in which the device ran nothing: one
minus the union of all device events (kernels and copies) over the
window, averaged over the devices."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
