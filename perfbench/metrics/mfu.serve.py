"""mfu.serve: the FLOPs the window's tokens needed (drivers/lm_serve.py:
prompts prefilled whole, each output token's matrix products, its row of
the tied head and its attention over its true context) over the window's
wall time, as a share of the card's dense bf16 peak, in %."""

from perfbench.counts.peaks import BF16_FLOPS


def read(ctx):
    c = ctx.counters
    if not c.get("window_s") or not c.get("window_flops"):
        return None
    return 100.0 * c["window_flops"] / c["window_s"] / BF16_FLOPS
