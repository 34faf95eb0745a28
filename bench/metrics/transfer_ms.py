"""Device time per step in host<->device copies: the union of the copy
events in the traced window, over the traced steps."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices:
        return None
    return ctx.trace.copy_ns() / len(ctx.trace.steps) / 1e6
