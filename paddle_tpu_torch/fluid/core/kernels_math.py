"""Math op kernels: elementwise family, mul/matmul, reductions, comparisons
(counterpart of paddle_tpu/fluid/core/kernels_math.py, as plain torch ops:
cuBLAS GEMMs and elementwise kernels on the card).

Capability parity with reference paddle/fluid/operators elementwise_*,
mul_op, matmul_op, reduce_op, scale_op, sum_op, clip ops, compare ops.
"""

from __future__ import annotations

import numpy as np
import torch

from .registry import register_op, torch_dtype


def _bcast_y(x, y, axis):
    """Fluid elementwise broadcast: align y's shape with x starting at `axis`
    (reference operators/elementwise_op_function.h trim-and-broadcast rule)."""
    if x.dim() == y.dim():
        return y
    if axis is None or axis == -1:
        axis = x.dim() - y.dim()
    new_shape = [1] * x.dim()
    for i, s in enumerate(y.shape):
        new_shape[axis + i] = s
    return y.reshape(new_shape)


def _elementwise(fn):
    def kern(ctx, ins, attrs):
        x = ins["X"][0]
        y = _bcast_y(x, ins["Y"][0], attrs.get("axis", -1))
        return {"Out": fn(x, y)}

    return kern


register_op("elementwise_add")(_elementwise(torch.add))
register_op("elementwise_sub")(_elementwise(torch.sub))
register_op("elementwise_mul")(_elementwise(torch.mul))
register_op("elementwise_div")(_elementwise(torch.true_divide))
register_op("elementwise_max")(_elementwise(torch.maximum))
register_op("elementwise_min")(_elementwise(torch.minimum))
register_op("elementwise_pow")(_elementwise(torch.pow))

register_op("less_than")(_elementwise(torch.lt))
register_op("less_equal")(_elementwise(torch.le))
register_op("greater_than")(_elementwise(torch.gt))
register_op("greater_equal")(_elementwise(torch.ge))
register_op("equal")(_elementwise(torch.eq))
register_op("not_equal")(_elementwise(torch.ne))


def _logical2(fn):
    def kern(ctx, ins, attrs):
        return {"Out": fn(ins["X"][0], ins["Y"][0])}

    return kern


register_op("logical_and")(_logical2(torch.logical_and))
register_op("logical_or")(_logical2(torch.logical_or))
register_op("logical_xor")(_logical2(torch.logical_xor))


@register_op("logical_not")
def _logical_not(ctx, ins, attrs):
    return {"Out": torch.logical_not(ins["X"][0])}


@register_op("mul")
def _mul(ctx, ins, attrs):
    """Reference mul_op: flatten X by x_num_col_dims / Y by y_num_col_dims,
    2-D matmul, reshape back (operators/mul_op.cc)."""
    x, y = ins["X"][0], ins["Y"][0]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    x2 = x.reshape(int(np.prod(x.shape[:xn])), -1) \
        if x.dim() > 2 or xn != 1 else x
    y2 = y.reshape(int(np.prod(y.shape[:yn])), -1) \
        if y.dim() > 2 or yn != 1 else y
    out = x2 @ y2
    return {"Out": out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))}


@register_op("matmul")
def _matmul(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    if x.dim() == 1:
        x = x.reshape(1, -1)
    if y.dim() == 1:
        y = y.reshape(-1, 1)
    if attrs.get("transpose_X", False):
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False):
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("scale")
def _scale(ctx, ins, attrs):
    x = ins["X"][0]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


@register_op("mean")
def _mean(ctx, ins, attrs):
    # reference mean_op produces a [1] tensor
    x = ins["X"][0]
    sp = ctx.spmd and ctx.spmd.input_split(ctx, "X")
    if sp:
        # the global mean: the ranks' sums over the global count
        total = ctx.spmd.all_reduce(torch.sum(x), sp.all_axes)
        return {"Out": (total / (x.numel() * ctx.spmd.extent(sp.all_axes))
                        ).reshape(1)}
    return {"Out": torch.mean(x).reshape(1)}


def _prod(x, dim, keepdim):
    for d in sorted((d % x.dim() for d in dim), reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


def _reduce(fn, kind):
    def kern(ctx, ins, attrs):
        x = ins["X"][0]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            dims = tuple(range(x.dim()))
        else:
            dim = attrs.get("dim", 0)
            dims = tuple(d % max(x.dim(), 1) for d in (
                dim if isinstance(dim, (list, tuple)) else (dim,)))
        sp = ctx.spmd and ctx.spmd.input_split(ctx, "X")
        if sp and sp.dim in dims:
            out = _global_reduce(ctx.spmd, sp, x, dims, keep, fn, kind)
        else:
            out = fn(x, dims, keep)
            if sp:  # a reduction over other dims keeps the split
                d = sp.dim if keep else sp.dim - sum(1 for a in dims
                                                     if a < sp.dim)
                ctx.spmd.mark(ctx.op.outputs["Out"][0], sp._replace(dim=d))
        if attrs.get("reduce_all", False):
            out = out.reshape((1,) * x.dim() if keep else (1,))
        return {"Out": out}

    return kern


def _global_reduce(spmd, sp, x, dims, keep, fn, kind):
    """A reduction over dims that include the split one: sums (and means,
    over the global count) all-reduce the local result; max, min and
    prod gather the ranks' partial results along the split dim and
    reduce them again (both differentiable)."""
    if kind in ("sum", "mean"):
        out = spmd.all_reduce(torch.sum(x, dim=dims, keepdim=keep),
                              sp.axes)
        if kind == "mean":
            count = spmd.extent(sp.axes)
            for d in dims:
                count *= x.shape[d]
            out = out / count
        return out
    part = spmd.gather(fn(x, dims, True), sp)
    out = fn(part, (sp.dim,), True)
    return out if keep else out.squeeze(dims)


register_op("reduce_sum")(_reduce(
    lambda x, d, k: torch.sum(x, dim=d, keepdim=k), "sum"))
register_op("reduce_mean")(_reduce(
    lambda x, d, k: torch.mean(x, dim=d, keepdim=k), "mean"))
register_op("reduce_max")(_reduce(
    lambda x, d, k: torch.amax(x, dim=d, keepdim=k), "max"))
register_op("reduce_min")(_reduce(
    lambda x, d, k: torch.amin(x, dim=d, keepdim=k), "min"))
register_op("reduce_prod")(_reduce(_prod, "prod"))


def _unary(fn):
    def kern(ctx, ins, attrs):
        return {"Out": fn(ins["X"][0])}

    return kern


register_op("square")(_unary(torch.square))
register_op("sqrt")(_unary(torch.sqrt))
register_op("rsqrt")(_unary(torch.rsqrt))
register_op("exp")(_unary(torch.exp))
register_op("log")(_unary(torch.log))
register_op("abs")(_unary(torch.abs))
register_op("ceil")(_unary(torch.ceil))
register_op("floor")(_unary(torch.floor))
register_op("round")(_unary(torch.round))
register_op("reciprocal")(_unary(lambda x: 1.0 / x))
register_op("sin")(_unary(torch.sin))
register_op("cos")(_unary(torch.cos))
register_op("sign")(_unary(torch.sign))


@register_op("pow")
def _pow(ctx, ins, attrs):
    return {"Out": torch.pow(ins["X"][0], attrs.get("factor", 1.0))}


@register_op("clip")
def _clip(ctx, ins, attrs):
    return {"Out": torch.clamp(ins["X"][0], attrs["min"], attrs["max"])}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    x = ins["X"][0]
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(_global_sum(ctx, "X", torch.sum(torch.square(x))))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp_min(norm, 1e-12),
                        torch.ones_like(norm))
    return {"Out": x * scale}


def _global_sum(ctx, slot, local):
    """`local`, a sum over all of input `slot`, summed over the ranks its
    blocks lie on when that input is split (a shard's norm is its
    parameter's)."""
    sp = ctx.spmd and ctx.spmd.input_split(ctx, slot)
    return ctx.spmd.all_reduce(local, sp.all_axes) if sp else local


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    return {"Out": _global_sum(ctx, "X", torch.sum(
        torch.square(ins["X"][0]))).reshape(1)}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs):
    sub = ins["X"][0] - ins["Y"][0]
    return {"sub_result": sub,
            "Out": torch.sum(torch.square(sub), dim=-1, keepdim=True)}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs):
    x, y = ins["X"][0], ins["Y"][0]
    xnorm = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    ynorm = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    out = torch.sum(x * y, dim=-1, keepdim=True) / (xnorm * ynorm + 1e-12)
    return {"Out": out, "XNorm": xnorm, "YNorm": ynorm}


@register_op("increment")
def _increment(ctx, ins, attrs):
    # preserve X's dtype (reference increment_op keeps the variable type)
    x = ins["X"][0]
    return {"Out": x + torch.tensor(attrs.get("step", 1.0)).to(x.dtype)}


@register_op("cast")
def _cast(ctx, ins, attrs):
    return {"Out": ins["X"][0].to(torch_dtype(attrs["out_dtype"]))}


@register_op("maxout")
def _maxout(ctx, ins, attrs):
    x = ins["X"][0]  # NCHW
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": torch.amax(x.reshape(n, c // groups, groups, h, w), dim=2)}


@register_op("l2_normalize")
def _l2_normalize(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    norm = torch.sqrt(torch.sum(torch.square(x), dim=axis, keepdim=True))
    norm = torch.clamp_min(norm, attrs.get("epsilon", 1e-12))
    return {"Out": x / norm, "Norm": norm}


@register_op("isfinite")
def _isfinite(ctx, ins, attrs):
    bad = torch.stack([(~torch.isfinite(x)).sum() for x in ins["X"]]).sum()
    axes = _split_axes(ctx, "X")
    if axes:  # a count of non-finite values over the ranks' blocks
        bad = ctx.spmd.all_reduce(bad, axes)
    return {"Out": (bad == 0).reshape(1)}


def _split_axes(ctx, slot):
    """The union of the mesh axes that split the inputs of `slot`."""
    spmd = ctx.spmd
    if spmd is None or not spmd.split:
        return ()
    out = []
    for n in ctx.op.inputs.get(slot, ()):
        sp = spmd.split_of(n)
        if sp is not None:
            out.extend(a for a in sp.all_axes if a not in out)
    return tuple(out)


@register_op("cumsum")
def _cumsum(ctx, ins, attrs):
    """Cumulative sum along an axis (reference cum_op.h): exclusive and
    reverse variants included."""
    x = ins["X"][0]
    axis = int(attrs.get("axis", -1))
    rev = bool(attrs.get("reverse", False))
    if rev:
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype)
    if attrs.get("exclusive", False):
        out = out - x
    if rev:
        out = torch.flip(out, (axis,))
    return {"Out": out}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs):
    """Out = sum(|x|) (reference operators/l1_norm_op.h)."""
    return {"Out": _global_sum(ctx, "X", torch.sum(
        torch.abs(ins["X"][0]))).reshape(1)}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs):
    """out = (1-eps)*label + eps*prior (uniform 1/K without PriorDist) —
    reference operators/label_smooth_op.h."""
    x = ins["X"][0]
    eps = attrs.get("epsilon", 0.0)
    prior = ins.get("PriorDist")
    if prior and prior[0] is not None:
        smooth = eps * prior[0].reshape(1, -1)
    else:
        smooth = eps / x.shape[-1]
    return {"Out": (1.0 - eps) * x + smooth}
