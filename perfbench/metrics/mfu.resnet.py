"""mfu.resnet: the training step's model FLOPs (3 x 2 x the multiply-adds
of the program's conv2d and mul ops, counted from their shapes) over the
whole window's wall time, as a share of the card's dense bf16 peak, in
%.
The count is fixed for the cell, so this reads the end-to-end rate
times a constant: it bounds every kernel's roofline from above, but no
layer's gain shows in it apart from the rate's."""

from perfbench.counts.peaks import BF16_FLOPS


def read(ctx):
    c = ctx.counters
    if not c.get("window_steps"):
        return None
    rate = (c["train_flops_per_image"] * c["batch"] * c["window_steps"]
            / c["window_s"])
    return 100.0 * rate / BF16_FLOPS
