"""NN op kernels: conv/pool/norm, activations, losses, dropout, metrics and
the flash-attention op (counterpart of paddle_tpu/fluid/core/kernels_nn.py).

Convolutions and pooling go to cuDNN through torch.nn.functional on NCHW
layouts; batch norm, layer norm and the losses are plain torch ops with
the JAX package's numerics (statistics in f32, the per-channel apply in
the input's dtype). The `flash_attention` op calls the port's flash
wrapper, which launches the Hopper kernels on CUDA tensors
(csrc/flash_attention.cu) and runs their plain versions on CPU tensors.

`lrn` sums the squares of a channel window in f32 and applies the
result in the input's dtype, as batch norm does.

The 3-D and transposed convolutions are cuDNN's too (F.conv3d,
F.conv_transpose2d / 3d); `pool3d` shares pool2d's semantics. The
`_with_index` pools gather each window's first maximum from strided
views (`unfold`) and give its flat index in the unpadded plane, which
`unpool` scatters by; `spp` pools each pyramid level through `_pool`.
`gaussian_random_noise` draws with the port's threefry, so its samples
are the JAX package's. Every op the JAX module registers is here.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...parallel.flash_attention import flash_attention
from ...utils import prng
from .registry import register_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


@register_op("conv2d")
def _conv2d(ctx, ins, attrs):
    x = ins["Input"][0]  # NCHW
    w = ins["Filter"][0]  # OIHW
    out = F.conv2d(x, w, stride=_pair(attrs.get("strides", [1, 1])),
                   padding=_pair(attrs.get("paddings", [0, 0])),
                   dilation=_pair(attrs.get("dilations", [1, 1])),
                   groups=int(attrs.get("groups", 1) or 1))
    return {"Output": out}


@register_op("depthwise_conv2d")
def _depthwise_conv2d(ctx, ins, attrs):
    attrs = dict(attrs)
    attrs["groups"] = ins["Input"][0].shape[1]
    return _conv2d(ctx, ins, attrs)


@register_op("conv3d")
def _conv3d(ctx, ins, attrs):
    x = ins["Input"][0]  # NCDHW
    w = ins["Filter"][0]  # OIDHW
    out = F.conv3d(x, w, stride=_triple(attrs.get("strides", [1, 1, 1])),
                   padding=_triple(attrs.get("paddings", [0, 0, 0])),
                   dilation=_triple(attrs.get("dilations", [1, 1, 1])),
                   groups=int(attrs.get("groups", 1) or 1))
    return {"Output": out}


def _conv_transpose(ins, attrs, nd):
    """Paddle's conv{2,3}d_transpose: conv's input-gradient with an
    [C_in, C_out, k...] filter (torch's own transposed-conv layout), so
    the output extent is (i - 1) * s - 2p + d * (k - 1) + 1 per spatial
    dim (conv_transpose_op.cc) with no output padding; the JAX package
    dilates the input and runs the flipped kernel, which is the same
    map. The reference op enforces groups == 1, as the JAX package
    does."""
    if int(attrs.get("groups", 1) or 1) != 1:
        raise NotImplementedError(
            "conv%dd_transpose requires groups == 1 (reference "
            "conv_transpose_op.cc)" % nd)
    tup = _pair if nd == 2 else _triple
    fn = F.conv_transpose2d if nd == 2 else F.conv_transpose3d
    ones = [1] * nd
    zeros = [0] * nd
    return {"Output": fn(
        ins["Input"][0], ins["Filter"][0],
        stride=tup(attrs.get("strides", ones)),
        padding=tup(attrs.get("paddings", zeros)),
        dilation=tup(attrs.get("dilations", ones)))}


@register_op("conv2d_transpose")
def _conv2d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 2)


@register_op("conv3d_transpose")
def _conv3d_transpose(ctx, ins, attrs):
    return _conv_transpose(ins, attrs, 3)


def _pool(x, pooling_type, ksize, strides, pads, global_pooling,
          ceil_mode=False, exclusive=True, nd=2):
    """The JAX package's `_pool` (reduce_window) on cuDNN's pooling, over
    the last `nd` dims: max pads with -inf, avg sums in f32 and divides
    by the count of unpadded cells when `exclusive` (else by the window
    size); `ceil_mode` widens the upper pad so the last partial window
    is kept. torch's own padding covers pads up to half the window
    without ceil_mode; any other case pads explicitly first."""
    if global_pooling:
        ksize = tuple(x.shape[-nd:])
        pads = (0,) * nd
    extra = [0] * nd
    if ceil_mode:
        for i in range(nd):
            rem = (x.shape[2 + i] + 2 * pads[i] - ksize[i]) % strides[i]
            extra[i] = (strides[i] - rem) % strides[i] if rem else 0
    native = not any(extra) and all(p <= k // 2 for p, k in zip(pads, ksize))
    explicit = ()
    for i in reversed(range(nd)):  # F.pad takes the last dim first
        explicit += (pads[i], pads[i] + extra[i])
    max_pool = F.max_pool2d if nd == 2 else F.max_pool3d
    avg_pool = F.avg_pool2d if nd == 2 else F.avg_pool3d
    if pooling_type == "max":
        if native:
            return max_pool(x, ksize, strides, pads)
        low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        return max_pool(F.pad(x, explicit, value=low), ksize, strides)
    xf = x.float()
    padded = any(pads) or any(extra)
    if native:
        out = avg_pool(xf, ksize, strides, pads,
                       count_include_pad=not (exclusive and padded))
    else:
        summed = avg_pool(F.pad(xf, explicit), ksize, strides,
                          divisor_override=1)
        if exclusive and padded:
            ones = F.pad(torch.ones_like(xf[:1, :1]), explicit)
            out = summed / avg_pool(ones, ksize, strides, divisor_override=1)
        else:
            out = summed / float(math.prod(ksize))
    return out.to(x.dtype)


@register_op("pool2d")
def _pool2d_op(ctx, ins, attrs):
    return {"Out": _pool(
        ins["X"][0], attrs.get("pooling_type", "max"),
        _pair(attrs.get("ksize", [1, 1])), _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        attrs.get("global_pooling", False), attrs.get("ceil_mode", False),
        attrs.get("exclusive", True))}


@register_op("pool3d")
def _pool3d_op(ctx, ins, attrs):
    return {"Out": _pool(
        ins["X"][0], attrs.get("pooling_type", "max"),
        _triple(attrs.get("ksize", [1, 1, 1])),
        _triple(attrs.get("strides", [1, 1, 1])),
        _triple(attrs.get("paddings", [0, 0, 0])),
        attrs.get("global_pooling", False), attrs.get("ceil_mode", False),
        attrs.get("exclusive", True), nd=3)}


@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs):
    """Reference operators/batch_norm_op.cc: NCHW, per-channel affine,
    running stats updated in train mode with Paddle's EMA (mean_out =
    mean_in * momentum + batch_mean * (1 - momentum)) over the BIASED
    variance E[x^2] - E[x]^2, all in f32; SavedVariance is the inverse
    std. F.batch_norm's own running-stat update (the opposite momentum
    convention, the unbiased variance) is not used."""
    x = ins["X"][0]
    scale, bias = ins["Scale"][0], ins["Bias"][0]
    mean_in, var_in = ins["Mean"][0], ins["Variance"][0]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    is_test = attrs.get("is_test", False) or ctx.is_test
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" else x.dim() - 1
    axes = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]

    # statistics always in f32 (a bf16 E[x^2]-E[x]^2 loses mass
    # catastrophically); only the per-channel apply runs in x's dtype
    if is_test:
        mean, var = mean_in.float(), var_in.float()
        mean_out, var_out = mean_in, var_in
    else:
        xs = x.float()
        sp = ctx.spmd and ctx.spmd.input_split(ctx, "X")
        if sp:
            # the global batch's statistics: the ranks' per-channel sums
            # of x and x^2 summed (differentiable), over the global count
            if sp.dim == c_axis:
                raise NotImplementedError(
                    "batch_norm over a tensor split along its channel axis")
            count = ctx.spmd.extent(sp.axes)
            for d in axes:
                count *= x.shape[d]
            sums = ctx.spmd.all_reduce(torch.stack([
                torch.sum(xs, dim=axes),
                torch.sum(torch.square(xs), dim=axes)]), sp.axes) / count
            mean = sums[0]
            var = sums[1] - torch.square(mean)
            ctx.spmd.mark(ctx.op.outputs["Y"][0], sp)
        else:
            mean = torch.mean(xs, dim=axes)
            var = torch.mean(torch.square(xs), dim=axes) \
                - torch.square(mean)
        with torch.no_grad():
            mean_out = mean_in.float() * momentum + mean * (1.0 - momentum)
            var_out = var_in.float() * momentum + var * (1.0 - momentum)
    inv = 1.0 / torch.sqrt(var + eps)
    # fold (mean, inv, scale, bias) into one per-channel multiply-add in
    # x's dtype: tiny vectors, the big activation never leaves its dtype
    eff_scale = (inv * scale.float()).to(x.dtype)
    eff_bias = (bias.float() - mean * inv * scale.float()).to(x.dtype)
    y = x * eff_scale.reshape(bshape) + eff_bias.reshape(bshape)
    return {"Y": y, "MeanOut": mean_out.detach(),
            "VarianceOut": var_out.detach(), "SavedMean": mean,
            "SavedVariance": 1.0 / torch.sqrt(var + eps)}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs):
    x = ins["X"][0]
    eps = attrs.get("epsilon", 1e-5)
    begin = attrs.get("begin_norm_axis", 1)
    axes = tuple(range(begin, x.dim()))
    # statistics in f32 (see batch_norm); apply in x's dtype
    xs = x.float()
    mean = torch.mean(xs, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xs - mean), dim=axes, keepdim=True)
    y = ((xs - mean) / torch.sqrt(var + eps)).to(x.dtype)
    pshape = (1,) * begin + tuple(x.shape[begin:])
    if ins.get("Scale"):
        y = y * ins["Scale"][0].reshape(pshape)
    if ins.get("Bias"):
        y = y + ins["Bias"][0].reshape(pshape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_op("lrn")
def _lrn(ctx, ins, attrs):
    """Local response normalisation across channels (reference
    operators/lrn_op.h): MidOut = k + alpha * (the sum of x^2 over a
    window of n channels, padded n//2 before and n-1-n//2 after, in
    f32), Out = x * MidOut^-beta in x's dtype. Not on the AMP deny-list:
    only the window sum is f32, the big activation keeps its dtype."""
    x = ins["X"][0]  # NCHW
    n = int(attrs.get("n", 5))
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    C = x.shape[1]
    sq = F.pad(torch.square(x.float()), (0, 0, 0, 0, half, n - 1 - half))
    acc = sq[:, 0:C]
    for i in range(1, n):
        acc = acc + sq[:, i:i + C]
    mid = k + alpha * acc
    return {"Out": x * torch.pow(mid, -beta).to(x.dtype), "MidOut": mid}


# --- activations --------------------------------------------------------

def _act(fn):
    def kern(ctx, ins, attrs):
        return {"Out": fn(ins["X"][0], attrs)}

    return kern


_ACTS = {
    "relu": lambda x, a: F.relu(x),
    "sigmoid": lambda x, a: torch.sigmoid(x),
    "tanh": lambda x, a: torch.tanh(x),
    "softsign": lambda x, a: x / (1 + torch.abs(x)),
    "softplus": lambda x, a: torch.logaddexp(x, torch.zeros_like(x)),
    "relu6": lambda x, a: torch.clamp(x, 0.0, 6.0),
    # jax.nn.gelu defaults to the tanh approximation
    "gelu": lambda x, a: F.gelu(x, approximate="tanh"),
    "elu": lambda x, a: F.elu(x),
    "silu": lambda x, a: F.silu(x),
    "logsigmoid": lambda x, a: F.logsigmoid(x),
    "tanh_shrink": lambda x, a: x - torch.tanh(x),
    "softshrink": lambda x, a: torch.sign(x) * torch.clamp_min(
        torch.abs(x) - a.get("lambda", 0.5), 0.0),
    "hard_shrink": lambda x, a: torch.where(
        torch.abs(x) > a.get("threshold", 0.5), x, torch.zeros_like(x)),
    "thresholded_relu": lambda x, a: torch.where(
        x > a.get("threshold", 1.0), x, torch.zeros_like(x)),
    "hard_sigmoid": lambda x, a: torch.clamp(
        x * a.get("slope", 0.2) + a.get("offset", 0.5), 0.0, 1.0),
    "leaky_relu": lambda x, a: F.leaky_relu(x, a.get("alpha", 0.02)),
    "brelu": lambda x, a: torch.clamp(x, a.get("t_min", 0.0),
                                      a.get("t_max", 24.0)),
    "stanh": lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
        x * a.get("scale_a", 2.0 / 3.0)),
    "swish": lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x),
}
for _name, _fn in _ACTS.items():
    register_op(_name)(_act(_fn))


@register_op("prelu")
def _prelu(ctx, ins, attrs):
    x = ins["X"][0]
    alpha = ins["Alpha"][0]
    if alpha.numel() > 1 and x.dim() >= 2:
        if alpha.numel() == math.prod(x.shape[1:]):
            alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
        else:  # channel mode: one alpha per channel (axis 1)
            alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": torch.where(x > 0, x, alpha * x)}


@register_op("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(ins["X"][0], dim=-1)}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs):
    return {"Out": torch.log_softmax(ins["X"][0], dim=-1)}


# --- losses -------------------------------------------------------------

def _hard(label):
    return label.reshape(label.shape[0]).long()[:, None]


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs):
    """Reference operators/cross_entropy_op.cc: X holds PROBABILITIES;
    hard labels are int [N, 1], soft labels a distribution of X's shape.
    Loss = -log(p[label] + 1e-8)."""
    x, label = ins["X"][0], ins["Label"][0]
    eps = 1e-8
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(x + eps), dim=-1, keepdim=True)
    else:
        loss = -torch.log(torch.gather(x, -1, _hard(label)) + eps)
    return {"Y": loss}


@register_op("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, ins, attrs):
    logits, label = ins["Logits"][0], ins["Label"][0]
    logp = torch.log_softmax(logits, dim=-1)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * logp, dim=-1, keepdim=True)
    else:
        loss = -torch.gather(logp, -1, _hard(label))
    return {"Softmax": torch.exp(logp), "Loss": loss}


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs):
    x, label = ins["X"][0], ins["Label"][0]
    return {"Out": torch.clamp_min(x, 0) - x * label
            + torch.log1p(torch.exp(-torch.abs(x)))}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs):
    logits = ins["Logits"][0]
    labels = ins["Labels"][0].to(logits.dtype)
    return {"Loss": torch.clamp_min(1.0 - (2.0 * labels - 1.0) * logits, 0.0)}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs):
    r = ins["Y"][0] - ins["X"][0]
    delta = attrs.get("delta", 1.0)
    absr = torch.abs(r)
    loss = torch.where(absr <= delta, 0.5 * r * r,
                       delta * (absr - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs):
    p, lbl = ins["Predicted"][0], ins["Labels"][0]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -lbl * torch.log(p + eps)
            - (1 - lbl) * torch.log(1 - p + eps)}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs):
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = ins["X"][0] - ins["Y"][0]
    if ins.get("InsideWeight"):
        diff = diff * ins["InsideWeight"][0]
    a = torch.abs(diff)
    val = torch.where(a < 1.0 / s2, 0.5 * s2 * diff * diff, a - 0.5 / s2)
    if ins.get("OutsideWeight"):
        val = val * ins["OutsideWeight"][0]
    out = torch.sum(val.reshape(val.shape[0], -1), dim=1, keepdim=True)
    return {"Out": out, "Diff": diff}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs):
    x1, x2, label = ins["X1"][0], ins["X2"][0], ins["Label"][0]
    act = torch.clamp_min(-label * (x1 - x2) + attrs.get("margin", 0.0), 0.0)
    return {"Out": act, "Activated": (act > 0).to(x1.dtype)}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs):
    d = ins["Left"][0] - ins["Right"][0]
    return {"Out": torch.log1p(torch.exp(d)) - ins["Label"][0] * d}


# --- dropout ------------------------------------------------------------

@register_op("dropout")
def _dropout(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs.get("dropout_prob", 0.5)
    if attrs.get("is_test", False) or ctx.is_test:
        # reference downscales at inference (upscale_in_train=False)
        return {"Out": x * (1.0 - p), "Mask": torch.ones_like(x)}
    # jax.random.bernoulli(key, 1 - p, shape): uniform bits < 1 - p; on
    # a mesh, this rank's rows of the draw over the global batch
    keep = prng.uniform(ctx.next_key(), tuple(x.shape),
                        offset=_draw_offset(ctx, "X", x.shape)) < (1.0 - p)
    mask = keep.to(x.dtype)
    return {"Out": x * mask, "Mask": mask}


def _draw_offset(ctx, slot, shape):
    """The flat offset of this rank's rows in a draw over the global
    batch when input `slot` is split over the batch (0 off a mesh)."""
    sp = ctx.spmd and ctx.spmd.input_split(ctx, slot)
    return ctx.spmd.global_draw(shape, sp)[1] if sp else 0


@register_op("gaussian_random_noise")
def _gaussian_noise(ctx, ins, attrs):
    """x + std * N(0, 1), the noise drawn with the port's threefry from
    the op's key, so the samples are the JAX package's own (float32; a
    bf16 x takes the f32 draw cast to bf16, where JAX draws in bf16)."""
    x = ins["X"][0]
    z = prng.normal(ctx.next_key(), tuple(x.shape),
                    offset=_draw_offset(ctx, "X", x.shape)).to(x.device)
    return {"Out": x + (z * attrs.get("std", 1.0)).to(x.dtype)}


# --- metrics ------------------------------------------------------------

def stable_topk(x, k):
    """The k largest entries of each row of x and their indices, ties in
    index order (lowest first), as `lax.top_k` orders them: a stable
    descending sort, then its first k. `torch.topk` leaves the order of
    ties to the device's algorithm."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@register_op("top_k")
def _top_k(ctx, ins, attrs):
    vals, idx = stable_topk(ins["X"][0], attrs.get("k", 1))
    return {"Out": vals, "Indices": idx.to(torch.int32)}


@register_op("accuracy")
def _accuracy(ctx, ins, attrs):
    indices, label = ins["Indices"][0], ins["Label"][0]
    lbl = label.reshape(label.shape[0], 1).to(indices.dtype)
    num_correct = torch.any(indices == lbl, dim=1).to(torch.int32).sum()
    rows = label.shape[0]
    sp = ctx.spmd and ctx.spmd.input_split(ctx, "Indices")
    if sp:  # the global batch's counts
        num_correct = ctx.spmd.all_reduce(num_correct, sp.axes)
        rows *= ctx.spmd.extent(sp.axes)
    total = torch.tensor(rows, dtype=torch.int32, device=indices.device)
    return {"Accuracy": (num_correct.float() / total.float()).reshape(1),
            "Correct": num_correct.reshape(1), "Total": total.reshape(1)}


@register_op("auc")
def _auc(ctx, ins, attrs):
    """Batch-local ROC AUC by threshold bucketing (reference auc_op.cc:
    the trapezoidal rule over score thresholds). The thresholds are
    jnp.linspace(0, 1, num)'s float32 values (i / (num - 1), then 1.0)
    and the area jnp.trapezoid's, negated (fpr falls as the threshold
    rises)."""
    pred = ins["Out"][0]
    label = ins["Label"][0].reshape(-1)
    score = pred[:, 1] if pred.dim() == 2 and pred.shape[1] == 2 \
        else pred.reshape(-1)
    num = int(attrs.get("num_thresholds", 200))
    dev = score.device
    thresholds = torch.cat([
        torch.arange(num - 1, dtype=torch.float32, device=dev) / (num - 1),
        torch.ones(1, device=dev)]) if num > 1 \
        else torch.zeros(1, device=dev)
    pos = (label > 0).float()
    neg = 1.0 - pos
    above = (score.float()[None, :] >= thresholds[:, None]).float()
    # per threshold: positives above, negatives above; then the totals
    counts = torch.cat([(above * pos).sum(1), (above * neg).sum(1),
                        pos.sum().reshape(1), neg.sum().reshape(1)])
    sp = ctx.spmd and ctx.spmd.input_split(ctx, "Out")
    if sp:  # the global batch's counts
        counts = ctx.spmd.all_reduce(counts, sp.axes)
    n = thresholds.shape[0]
    tpr = counts[:n] / torch.clamp_min(counts[2 * n], 1.0)
    fpr = counts[n:2 * n] / torch.clamp_min(counts[2 * n + 1], 1.0)
    area = 0.5 * ((fpr[1:] - fpr[:-1]) * (tpr[1:] + tpr[:-1])).sum()
    return {"AUC": (-area).reshape(1)}


@register_op("flash_attention")
def _flash_attention(ctx, ins, attrs):
    """Blockwise attention on [B, T, H, D] through the port's flash
    wrapper: on CUDA tensors the hand-written kernels, forward and
    backward (dK/dV, dQ), with no other route; on CPU tensors their plain
    versions."""
    q, k, v = ins["Q"][0], ins["K"][0], ins["V"][0]
    return {"Out": flash_attention(
        q, k, v, causal=bool(attrs.get("causal", False)),
        scale=attrs.get("scale") or None)}


# --- pooling with index, unpool, spp -------------------------------------

def _pool_with_index(x, ksize, strides, pads, global_pooling, nd):
    """Max pooling that also returns the argmax's flat index within the
    UNPADDED input plane (reference math/pooling.cc
    MaxPool2dWithIndexFunctor: index = h * input_w + w), as the JAX
    package's `_pool_with_index`: the pad cells hold the dtype's lowest
    finite value, so an input cell wins any tie with one; the windows
    are strided views of the padded input (`unfold`), and ties take the
    first maximum in window scan order (torch.argmax and jnp.argmax
    both return the first). Out is gathered at the argmax, so the
    gradient goes to that one cell, as jax.vjp routes it."""
    spatial = tuple(x.shape[2:])
    if global_pooling:
        ksize, pads = spatial, (0,) * nd
    low = torch.finfo(x.dtype).min if x.is_floating_point() \
        else torch.iinfo(x.dtype).min
    pad = ()
    for i in reversed(range(nd)):
        pad += (pads[i], pads[i])
    win = F.pad(x, pad, value=low)
    for i in range(nd):
        win = win.unfold(2 + i, ksize[i], strides[i])
    out_dims = tuple(win.shape[2:2 + nd])
    kprod = math.prod(ksize)
    win = win.reshape(win.shape[:2 + nd] + (kprod,))
    arg = torch.argmax(win, dim=-1, keepdim=True)
    out = torch.gather(win, -1, arg)[..., 0]
    # each window cell's flat index in the unpadded plane, row-major (a
    # host constant of the static shapes, as in the JAX package)
    mult = np.cumprod((spatial[1:] + (1,))[::-1])[::-1]
    o_grid = np.meshgrid(*[np.arange(o) for o in out_dims], indexing="ij")
    k_grid = np.meshgrid(*[np.arange(k) for k in ksize], indexing="ij")
    coord = np.zeros((math.prod(out_dims), kprod), np.int64)
    for i in range(nd):
        coord += (o_grid[i].reshape(-1, 1) * strides[i]
                  + k_grid[i].reshape(1, -1) - pads[i]) * int(mult[i])
    coord = torch.from_numpy(coord.reshape(out_dims + (kprod,)).astype(
        np.int32)).to(x.device, non_blocking=True)
    mask = torch.gather(coord.expand(arg.shape[:-1] + (kprod,)), -1,
                        arg)[..., 0]
    return out, mask


@register_op("max_pool2d_with_index")
def _max_pool2d_with_index(ctx, ins, attrs):
    """Reference operators/pool_with_index_op.cc (2-D)."""
    out, mask = _pool_with_index(
        ins["X"][0], _pair(attrs.get("ksize", [1, 1])),
        _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        attrs.get("global_pooling", False), nd=2)
    return {"Out": out, "Mask": mask}


@register_op("max_pool3d_with_index")
def _max_pool3d_with_index(ctx, ins, attrs):
    """Reference operators/pool_with_index_op.cc (3-D, NCDHW)."""
    out, mask = _pool_with_index(
        ins["X"][0], _triple(attrs.get("ksize", [1, 1, 1])),
        _triple(attrs.get("strides", [1, 1, 1])),
        _triple(attrs.get("paddings", [0, 0, 0])),
        attrs.get("global_pooling", False), nd=3)
    return {"Out": out, "Mask": mask}


@register_op("unpool")
def _unpool(ctx, ins, attrs):
    """Max unpooling (reference operators/unpool_op.cc +
    math/unpooling.cc): each input element goes to the output-plane
    position its Indices entry names (the `_with_index` pools' Mask);
    everything else is zero. Output size = (in - 1) * stride - 2 * pad
    + ksize per spatial dim. An index outside the plane is dropped, as
    the JAX package's `mode="drop"` scatter drops it (negative indices
    count from the end first, as JAX normalises them): it is aimed at
    one spare slot past the plane, cut off afterwards."""
    x = ins["X"][0]  # [N, C, H, W]
    ksize = _pair(attrs.get("ksize", [1, 1]))
    strides = _pair(attrs.get("strides", [1, 1]))
    pads = _pair(attrs.get("paddings", [0, 0]))
    n, c, h, w = x.shape
    oh = (h - 1) * strides[0] - 2 * pads[0] + ksize[0]
    ow = (w - 1) * strides[1] - 2 * pads[1] + ksize[1]
    plane = oh * ow
    idx = ins["Indices"][0].reshape(n, c, -1).long()
    idx = torch.where(idx < 0, idx + plane, idx)
    idx = torch.where((idx < 0) | (idx >= plane), plane, idx)
    flat = torch.zeros((n, c, plane + 1), dtype=x.dtype, device=x.device)
    out = flat.scatter(2, idx, x.reshape(n, c, -1))
    return {"Out": out[..., :plane].reshape(n, c, oh, ow)}


@register_op("spp")
def _spp(ctx, ins, attrs):
    """Spatial pyramid pooling (reference operators/spp_op.cc): level p
    of pyramid_height pools to 2^p x 2^p bins (ksize = ceil(in / bins),
    stride = ksize, the pad centring the grid), flattened and
    concatenated along channels * bins^2."""
    x = ins["X"][0]
    height = int(attrs.get("pyramid_height", 1))
    ptype = attrs.get("pooling_type", "max")
    n, c, h, w = x.shape
    parts = []
    for p in range(height):
        bins = 2 ** p
        kh, kw = -(-h // bins), -(-w // bins)
        ph, pw = (kh * bins - h + 1) // 2, (kw * bins - w + 1) // 2
        lvl = _pool(x, ptype, (kh, kw), (kh, kw), (ph, pw),
                    global_pooling=False, exclusive=True)
        parts.append(lvl.reshape(n, c * bins * bins))
    return {"Out": torch.cat(parts, dim=1)}


# --- norm, bilinear product, the last loss and activation ----------------

@register_op("norm")
def _norm(ctx, ins, attrs):
    """SSD-style cross-channel L2 normalisation with a learned
    per-channel scale (reference operators/norm_op.h): out = x /
    sqrt(eps + sum_c x^2) * scale[c], the sum of squares in f32."""
    x = ins["X"][0]
    scale = ins["Scale"][0].reshape(-1)
    eps = attrs.get("epsilon", 1e-10)
    denom = torch.sqrt(eps + torch.sum(torch.square(x.float()), dim=1,
                                       keepdim=True))
    out = (x / denom) * scale.reshape((1, -1) + (1,) * (x.dim() - 2))
    return {"Out": out.to(x.dtype)}


@register_op("bilinear_tensor_product")
def _bilinear_tensor_product(ctx, ins, attrs):
    """out[b, k] = x[b, :] @ W[k] @ y[b, :] + bias[k] (reference
    operators/bilinear_tensor_product_op.h)."""
    x, y, w = ins["X"][0], ins["Y"][0], ins["Weight"][0]  # W [size, M, N]
    out = torch.einsum("bm,kmn,bn->bk", x, w, y)
    if ins.get("Bias") and ins["Bias"][0] is not None:
        out = out + ins["Bias"][0].reshape(1, -1)
    return {"Out": out}


@register_op("modified_huber_loss")
def _modified_huber_loss(ctx, ins, attrs):
    """Reference operators/modified_huber_loss_op.h: a = x * (2y - 1);
    loss = -4a for a < -1, (1 - a)^2 for a < 1, else 0. Y in {0, 1}."""
    x = ins["X"][0]
    a = x * (2.0 * ins["Y"][0].to(x.dtype) - 1.0)
    loss = torch.where(a < -1.0, -4.0 * a,
                       torch.where(a < 1.0, torch.square(1.0 - a),
                                   torch.zeros_like(a)))
    return {"IntermediateVal": a, "Out": loss}


@register_op("soft_relu")
def _soft_relu(ctx, ins, attrs):
    """out = log(1 + exp(clip(x, -t, t))) (reference activation_op.h
    SoftReluFunctor), the clip straight-through for the gradient: the
    reference backward dx = dout * (1 - exp(-out)) is the sigmoid of
    the CLIPPED input everywhere, where a plain clamp would zero the
    gradient outside [-t, t]."""
    x = ins["X"][0]
    t = attrs.get("threshold", 40.0)
    xc = x + (torch.clamp(x, -t, t) - x).detach()
    return {"Out": torch.log1p(torch.exp(xc))}
