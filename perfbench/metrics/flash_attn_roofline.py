"""flash_attn_roofline: the least time of the traced steps' causal
attention (forward and backward of every layer, counts/lm.py) over the
device time of the port's flash kernels (csrc/flash_attention.cu) in
the trace, in %."""


def read(ctx):
    if ctx.trace is None or not ctx.counters.get("slice_steps"):
        return None
    spent = ctx.trace.device_s(lambda n: "flash_" in n)
    if spent <= 0:
        return None
    least = ctx.counters["flash_least_s_per_step"] * ctx.counters[
        "slice_steps"]
    return 100.0 * least / spent
