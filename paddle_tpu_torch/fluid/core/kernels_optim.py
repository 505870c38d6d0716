"""Optimizer-update op kernels (counterpart of
paddle_tpu/fluid/core/kernels_optim.py).

Parity with the reference's optimizer ops (operators/sgd_op.cc,
momentum_op, adagrad_op, adam_op, adamax_op, decayed_adagrad_op,
rmsprop_op, adadelta_op, ftrl_op, proximal_gd_op, proximal_adagrad_op).
The executor runs these ops under torch.no_grad(), and each updates its
parameter and state tensors IN PLACE: the JAX executor donates the
scope's buffers to the compiled step, and writing into the scope's own
tensors is the port's counterpart (no second copy of the model). Where
an op's output names another variable than its input, the kernel
updates a copy instead.

A gradient is a dense tensor or, for an embedding table that takes the
sparse path (lowering._find_sparse_sites), a SelectedRows. sgd,
momentum, adagrad and adam have the reference's SelectedRows branches:
sgd scatter-adds the rows; the others update lazily, on the merged
touched rows only, so an untouched row keeps its parameter and state
bit for bit. The other rules densify a SelectedRows to the exact dense
gradient (`_grad`), as the JAX package does; the lowering never sends
them one.
"""

from __future__ import annotations

import torch

from .registry import register_op
from .selected_rows import SelectedRows, _col, as_dense


def _lr(ins):
    return ins["LearningRate"][0].reshape(())


def _grad(ins):
    """The dense gradient: a SelectedRows arriving at a rule without a
    sparse branch densifies to the exact dense gradient."""
    return as_dense(ins["Grad"][0])


def _lazy_rows(g, dtype):
    """The merged rows of a SelectedRows as update targets: (targets,
    valid, values). A sentinel slot (row == height) is aimed at slot
    0's row, which after the merge's sort is a real row unless every id
    was padding (then at row height - 1); `_lazy_write` gives it the
    value slot 0 writes, so the duplicate writes carry identical bytes
    and the sentinel changes nothing."""
    r, gv = g.merged()
    valid = r < g.height
    first = torch.where(valid[0], r[0], g.height - 1)
    return torch.where(valid, r, first), valid, gv.to(dtype)


def _lazy_write(t, rows, valid, new, old):
    """Write `new` [n, ...] into the rows of `t` (in place); sentinel
    slots write slot 0's value (`new[0]` when slot 0 is a real row, the
    row's own `old[0]` when every slot is a sentinel)."""
    fill = torch.where(valid[0], new[0], old[0])
    t.index_copy_(0, rows, torch.where(_col(valid, new), new, fill))


def _inplace(ctx, ins, in_slot, out_slot):
    """The tensor an update of `in_slot` writes: the input itself when the
    op's `out_slot` names the same variable (every optimizer op the
    Optimizer classes append), else a copy."""
    t = ins[in_slot][0]
    same = ctx.op.outputs.get(out_slot) == ctx.op.inputs.get(in_slot)
    return t if same else t.clone()


@register_op("sgd")
def _sgd(ctx, ins, attrs):
    g = ins["Grad"][0]
    p = _inplace(ctx, ins, "Param", "ParamOut")
    if isinstance(g, SelectedRows):
        # reference sgd_op.cc SelectedRows branch: a row scatter-add;
        # duplicate rows accumulate, a sentinel adds 0.0 to row 0
        valid = g.rows < g.height
        upd = (-_lr(ins)) * g.values.to(p.dtype)
        upd = torch.where(_col(valid, upd), upd, torch.zeros_like(upd))
        return {"ParamOut": p.index_add_(
            0, torch.where(valid, g.rows, 0), upd)}
    return {"ParamOut": p.sub_(_lr(ins) * g)}


@register_op("momentum")
def _momentum(ctx, ins, attrs):
    g = ins["Grad"][0]
    p = _inplace(ctx, ins, "Param", "ParamOut")
    v = _inplace(ctx, ins, "Velocity", "VelocityOut")
    mu, lr = attrs["mu"], _lr(ins)
    if isinstance(g, SelectedRows):
        # lazy update: the velocity decays only on touched rows
        r, valid, gv = _lazy_rows(g, p.dtype)
        v_r, p_r = v.index_select(0, r), p.index_select(0, r)
        v_new = mu * v_r + gv
        if attrs.get("use_nesterov", False):
            step = (gv + mu * v_new) * lr
        else:
            step = lr * v_new
        _lazy_write(p, r, valid, p_r - step, p_r)
        _lazy_write(v, r, valid, v_new, v_r)
        return {"ParamOut": p, "VelocityOut": v}
    v.mul_(mu).add_(g)
    if attrs.get("use_nesterov", False):
        p.sub_((g + mu * v) * lr)
    else:
        p.sub_(lr * v)
    return {"ParamOut": p, "VelocityOut": v}


@register_op("adagrad")
def _adagrad(ctx, ins, attrs):
    g = ins["Grad"][0]
    p = _inplace(ctx, ins, "Param", "ParamOut")
    m = _inplace(ctx, ins, "Moment", "MomentOut")
    if isinstance(g, SelectedRows):
        # reference adagrad_op.h SelectedRows branch: duplicates merged
        # (MergeAdd), then the moment and the parameter of each touched
        # row
        r, valid, gv = _lazy_rows(g, p.dtype)
        m_r, p_r = m.index_select(0, r), p.index_select(0, r)
        m_new = m_r + gv * gv
        p_new = p_r - _lr(ins) * gv / (
            torch.sqrt(m_new) + attrs.get("epsilon", 1e-6))
        _lazy_write(p, r, valid, p_new, p_r)
        _lazy_write(m, r, valid, m_new, m_r)
        return {"ParamOut": p, "MomentOut": m}
    m.add_(g * g)
    p.sub_(_lr(ins) * g / (torch.sqrt(m) + attrs.get("epsilon", 1e-6)))
    return {"ParamOut": p, "MomentOut": m}


@register_op("adam")
def _adam(ctx, ins, attrs):
    g = ins["Grad"][0]
    p = _inplace(ctx, ins, "Param", "ParamOut")
    m1 = _inplace(ctx, ins, "Moment1", "Moment1Out")
    m2 = _inplace(ctx, ins, "Moment2", "Moment2Out")
    b1p = ins["Beta1Pow"][0].reshape(())
    b2p = ins["Beta2Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
    if isinstance(g, SelectedRows):
        # lazy adam (reference adam_op.h SparseAdamFunctor): the moments
        # decay and the parameter moves only on touched rows; untouched
        # rows keep their state bit for bit (a documented divergence
        # from dense adam, as in the reference's sparse branch)
        r, valid, gv = _lazy_rows(g, p.dtype)
        m1_r, m2_r = m1.index_select(0, r), m2.index_select(0, r)
        p_r = p.index_select(0, r)
        m1_new = b1 * m1_r + (1.0 - b1) * gv
        m2_new = b2 * m2_r + (1.0 - b2) * gv * gv
        p_new = p_r - lr * m1_new / (torch.sqrt(m2_new) + eps)
        _lazy_write(p, r, valid, p_new, p_r)
        _lazy_write(m1, r, valid, m1_new, m1_r)
        _lazy_write(m2, r, valid, m2_new, m2_r)
        return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}
    m1.mul_(b1).add_((1.0 - b1) * g)
    m2.mul_(b2).add_((1.0 - b2) * g * g)
    p.sub_(lr * m1 / (torch.sqrt(m2) + eps))
    return {"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2}


@register_op("adamax")
def _adamax(ctx, ins, attrs):
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    m = _inplace(ctx, ins, "Moment", "MomentOut")
    inf = _inplace(ctx, ins, "InfNorm", "InfNormOut")
    b1p = ins["Beta1Pow"][0].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    m.mul_(b1).add_((1.0 - b1) * g)
    torch.maximum(b2 * inf, torch.abs(g) + attrs.get("epsilon", 1e-8),
                  out=inf)
    p.sub_(_lr(ins) / (1.0 - b1p) * m / inf)
    return {"ParamOut": p, "MomentOut": m, "InfNormOut": inf}


@register_op("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    m = _inplace(ctx, ins, "Moment", "MomentOut")
    decay = attrs.get("decay", 0.95)
    m.mul_(decay).add_((1.0 - decay) * g * g)
    p.sub_(_lr(ins) * g / (torch.sqrt(m) + attrs.get("epsilon", 1e-6)))
    return {"ParamOut": p, "MomentOut": m}


@register_op("rmsprop")
def _rmsprop(ctx, ins, attrs):
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    ms = _inplace(ctx, ins, "MeanSquare", "MeanSquareOut")
    mom = _inplace(ctx, ins, "Moment", "MomentOut")
    decay = attrs.get("decay", 0.9)
    ms.mul_(decay).add_((1.0 - decay) * g * g)
    mom.mul_(attrs.get("momentum", 0.0)).add_(
        _lr(ins) * g / torch.sqrt(ms + attrs.get("epsilon", 1e-10)))
    p.sub_(mom)
    return {"ParamOut": p, "MomentOut": mom, "MeanSquareOut": ms}


@register_op("adadelta")
def _adadelta(ctx, ins, attrs):
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    ag = _inplace(ctx, ins, "AvgSquaredGrad", "AvgSquaredGradOut")
    au = _inplace(ctx, ins, "AvgSquaredUpdate", "AvgSquaredUpdateOut")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    ag.mul_(rho).add_((1.0 - rho) * g * g)
    update = -torch.sqrt((au + eps) / (ag + eps)) * g
    au.mul_(rho).add_((1.0 - rho) * update * update)
    p.add_(update)
    return {"ParamOut": p, "AvgSquaredGradOut": ag, "AvgSquaredUpdateOut": au}


@register_op("ftrl")
def _ftrl(ctx, ins, attrs):
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    sq = _inplace(ctx, ins, "SquaredAccumulator", "SquaredAccumOut")
    lin = _inplace(ctx, ins, "LinearAccumulator", "LinearAccumOut")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + g * g
    if lr_power == -0.5:
        sigma = (torch.sqrt(new_sq) - torch.sqrt(sq)) / lr
        denom = l2 + torch.sqrt(new_sq) / lr
    else:
        sigma = (torch.pow(new_sq, -lr_power) - torch.pow(sq, -lr_power)) / lr
        denom = l2 + torch.pow(new_sq, -lr_power) / lr
    lin.add_(g - sigma * p)
    sq.copy_(new_sq)
    pre = torch.sign(lin) * l1 - lin
    p.copy_(torch.where(torch.abs(lin) > l1, pre / denom,
                        torch.zeros_like(p)))
    return {"ParamOut": p, "SquaredAccumOut": sq, "LinearAccumOut": lin}


def _prox_project(prox, lr, attrs):
    """Soft-threshold by lr*l1 then shrink by 1/(1+lr*l2) — the shared
    projection of proximal_gd/proximal_adagrad (reference
    proximal_gd_op.h / proximal_adagrad_op.h)."""
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    if l1 > 0:
        return torch.sign(prox) * (
            torch.clamp_min(torch.abs(prox) - lr * l1, 0.0) / (1.0 + lr * l2))
    return prox / (1.0 + lr * l2)


@register_op("proximal_gd")
def _proximal_gd(ctx, ins, attrs):
    """Proximal gradient descent (reference operators/proximal_gd_op.h)."""
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    lr = _lr(ins)
    return {"ParamOut": p.copy_(_prox_project(p - lr * g, lr, attrs))}


@register_op("proximal_adagrad")
def _proximal_adagrad(ctx, ins, attrs):
    """Reference operators/proximal_adagrad_op.h: adagrad moment, then
    the same proximal projection as proximal_gd."""
    g = _grad(ins)
    p = _inplace(ctx, ins, "Param", "ParamOut")
    m = _inplace(ctx, ins, "Moment", "MomentOut")
    lr = _lr(ins)
    m.add_(g * g)
    prox = p - lr * g / torch.sqrt(m)
    return {"ParamOut": p.copy_(_prox_project(prox, lr, attrs)),
            "MomentOut": m}


@register_op("average_accumulates")
def _average_accumulates(ctx, ins, attrs):
    """Sliding-window parameter averaging accumulator (the JAX package's
    kernels_optim.py:242; reference parameter/AverageOptimizer.cpp:60-115).
    Per step: sum_1 += param and the counters advance; every
    k_max_num_accumulates updates sum_1 folds into sum_2; once the
    window min(max_average_window, num_updates * average_window) is
    reached the sums shift into sum_3 and the window restarts. Every
    branch is a select on the device (no host read); the counters stay
    int32 and the sums keep their dtype."""
    p = ins["Param"][0]
    s1, s2, s3 = ins["InSum1"][0], ins["InSum2"][0], ins["InSum3"][0]
    na = ins["InNumAccumulates"][0] + 1
    ona = ins["InOldNumAccumulates"][0]
    nu = ins["InNumUpdates"][0] + 1
    rate = float(attrs.get("average_window", 0.0))
    max_w = int(attrs.get("max_average_window", 10000))
    min_w = int(attrs.get("min_average_window", 10000))
    k_max = int(attrs.get("k_max_num_accumulates", 16384))

    zero = torch.zeros((), dtype=s1.dtype, device=s1.device)
    s1 = s1 + p.to(s1.dtype)
    fold = (nu % k_max) == 0
    s2 = torch.where(fold, s2 + s1, s2)
    s1 = torch.where(fold, zero, s1)
    window = torch.clamp_max(nu.float() * rate, float(max_w))
    shift = (na >= min_w) & (na.float() >= window)
    s3 = torch.where(shift, s1 + s2, s3)
    s1 = torch.where(shift, zero, s1)
    s2 = torch.where(shift, zero, s2)
    ona = torch.where(shift, na, ona)
    na = torch.where(shift, torch.zeros_like(na), na)
    return {"OutSum1": s1, "OutSum2": s2, "OutSum3": s3,
            "OutNumAccumulates": na, "OutOldNumAccumulates": ona,
            "OutNumUpdates": nu}
