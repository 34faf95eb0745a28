"""Device compute time per step: the union of kernel events (copies
left out) in the traced window, over the traced steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    ns = ctx.trace.kernel_ns()
    return ns / len(ctx.trace.steps) / 1e6 if ns > 0 else None
