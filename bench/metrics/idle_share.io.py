"""``idle_share`` of the cells that move host arrays: one minus the
union of all device events (kernels and copies) over the traced
window, averaged over the devices."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_ns() / ctx.trace.window_ns)
