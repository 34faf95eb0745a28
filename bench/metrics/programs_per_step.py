"""XLA programs launched per step: ``PJRT_LoadedExecutable_Execute``
events inside the traced steps' spans."""


def read(ctx):
    if ctx.trace is None:
        return None
    return ctx.trace.executions_per_step()
