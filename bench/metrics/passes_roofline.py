"""Share of the roofline: the least time the step's irreducible work
can take on this device (the configuration's ``work``: bytes over peak
HBM bandwidth or FLOPs over peak float32 rate, whichever is larger)
over the device compute time per step.  The work is fixed by the shapes,
so whatever implements the step, the share cannot pass 100% unless a
peak in the table is wrong."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.devices or ctx.peaks is None:
        return None
    ns = ctx.trace.kernel_ns()
    if ns <= 0:
        return None
    least = max(ctx.work["bytes"] / ctx.peaks["hbm_bytes_per_s"],
                ctx.work["flops"] / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least / (ns / len(ctx.trace.steps) / 1e9)
