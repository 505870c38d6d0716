"""engine_host_share.serve: the share of the window outside the engine's
dispatch-to-sync spans (ServingMetrics.device_busy_s, the union the
engine records), i.e. its host_overhead_frac over the window, in %."""


def read(ctx):
    c = ctx.counters
    if not c.get("window_s"):
        return None
    return 100.0 * (1.0 - c["engine_busy_s"] / c["window_s"])
