"""Multiply-adds of a convolutional network, counted from shapes: a
convolution's output elements times its filter's fan-in, a fully
connected layer's inputs times its outputs. One multiply-add is two
FLOPs; a training step is three forwards."""

import math


def conv_macs(c_out, c_in_per_group, kh, kw, h_out, w_out):
    """Multiply-adds of one image through one convolution."""
    return c_out * h_out * w_out * c_in_per_group * kh * kw


def fc_macs(n_in, n_out):
    return n_in * n_out


def program_macs(block):
    """Multiply-adds per image of a Fluid block's conv2d and mul ops, from
    the static shapes of their inputs, filters and outputs (the batch
    dimension, -1, left out)."""
    total = 0
    for op in block.ops:
        if op.type == "conv2d":
            w = block.var(op.inputs["Filter"][0]).shape
            out = block.var(op.outputs["Output"][0]).shape
            total += conv_macs(w[0], w[1], w[2], w[3], out[-2], out[-1])
        elif op.type == "mul":
            x = block.var(op.inputs["X"][0]).shape
            y = block.var(op.inputs["Y"][0]).shape
            k = op.attrs.get("x_num_col_dims", 1)
            total += fc_macs(math.prod(x[k:]), math.prod(y[1:]))
    return total


def train_flops_per_image(macs):
    return 3 * 2 * macs
