"""conv_ms.resnet: device milliseconds a step of the kernels in the
`conv` class (lib/kernel_classes.py) over the traced steps."""

from perfbench.lib.kernel_classes import fluid_class


def read(ctx):
    steps = ctx.counters.get("slice_steps")
    if ctx.trace is None or not steps:
        return None
    s = ctx.trace.device_s(lambda n: fluid_class(n) == "conv")
    return 1e3 * s / steps if s > 0 else None
