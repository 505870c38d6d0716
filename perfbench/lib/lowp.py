"""The controls' lower precision: float8 in the program's place where the
configuration states bfloat16, in the usual recipe for fp8 training
(Micikevicius et al. 2022, "FP8 Formats for Deep Learning"): values of
the forward in e4m3, gradients in e5m2, each tensor under one scale (its
largest magnitude at the format's largest finite value), products
accumulated in float32. A control computed so has to come out as not
correct: it is the step a later change would be tempted by.

`fp8_matmul` and `fp8_conv2d` round their operands, forward and in both
products of the backward; `fp8_act` rounds a stored activation and the
gradient that flows back through it (the bf16 tensors an AMP forward
keeps, where the reference keeps float32).

The `bf16_*` functions do the same in bfloat16, forward and backward,
with float32 sums: the reference computed as a bf16 AMP step computes,
a witness of what bf16 rounding alone does to a reading, never a
control."""

import torch

E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def q8(x, fmt=E4M3):
    """x rounded to an fp8 format under a per-tensor scale, returned in
    x's dtype."""
    dtype, top = fmt
    amax = x.detach().abs().amax().float().clamp_min(1e-30)
    scale = top / amax
    return ((x.float() * scale).to(dtype).float() / scale).to(x.dtype)


def bf16(x):
    """x rounded to bfloat16, returned in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


def _e5m2(g):
    return q8(g, E5M2)


class _LowMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, fwd, bwd):
        qa, qb = fwd(a), fwd(b)
        ctx.save_for_backward(qa, qb)
        ctx.bwd = bwd
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.bwd(g)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg, \
            None, None


def fp8_matmul(a, b):
    return _LowMatmul.apply(a, b, q8, _e5m2)


def bf16_matmul(a, b):
    return _LowMatmul.apply(a, b, bf16, bf16)


class _LowConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding, fwd, bwd):
        qx, qw = fwd(x), fwd(w)
        ctx.save_for_backward(qx, qw)
        ctx.conf = (stride, padding, bwd)
        return torch.nn.functional.conv2d(qx, qw, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        qx, qw = ctx.saved_tensors
        stride, padding, bwd = ctx.conf
        qg = bwd(g)
        gx = torch.nn.grad.conv2d_input(qx.shape, qw, qg, stride, padding)
        gw = torch.nn.grad.conv2d_weight(qx, qw.shape, qg, stride, padding)
        return gx, gw, None, None, None, None


def fp8_conv2d(x, w, stride, padding):
    return _LowConv.apply(x, w, stride, padding, q8, _e5m2)


def bf16_conv2d(x, w, stride, padding):
    return _LowConv.apply(x, w, stride, padding, bf16, bf16)


class _LowAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def fp8_act(x):
    return _LowAct.apply(x, q8, _e5m2)


def bf16_act(x):
    return _LowAct.apply(x, bf16, bf16)
