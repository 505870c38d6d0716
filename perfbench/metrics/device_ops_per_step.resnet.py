"""device_ops_per_step.resnet: operations launched on the card a step
(kernels, copies and sets) over the traced steps."""


def read(ctx):
    steps = ctx.counters.get("slice_steps")
    if ctx.trace is None or not steps:
        return None
    return ctx.trace.count() / steps
