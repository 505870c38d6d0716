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

Not ported yet (ROADMAP, Queue A): conv2d_transpose, conv3d, pool3d,
gaussian_random_noise, max_pool*_with_index, unpool, spp,
conv3d_transpose, norm, bilinear_tensor_product, modified_huber_loss,
soft_relu.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...parallel.flash_attention import flash_attention
from ...utils import prng
from .registry import register_op


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


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


def _pool2d(x, pooling_type, ksize, strides, pads, global_pooling,
            ceil_mode=False, exclusive=True):
    """The JAX package's `_pool` (reduce_window) on cuDNN's pooling: max
    pads with -inf, avg sums in f32 and divides by the count of unpadded
    cells when `exclusive` (else by the window size); `ceil_mode` widens
    the upper pad so the last partial window is kept. torch's own
    padding covers pads up to half the window without ceil_mode; any
    other case pads explicitly first."""
    if global_pooling:
        ksize = tuple(x.shape[-2:])
        pads = (0, 0)
    extra = [0, 0]
    if ceil_mode:
        for i in range(2):
            rem = (x.shape[2 + i] + 2 * pads[i] - ksize[i]) % strides[i]
            extra[i] = (strides[i] - rem) % strides[i] if rem else 0
    native = not any(extra) and all(p <= k // 2 for p, k in zip(pads, ksize))
    explicit = (pads[1], pads[1] + extra[1], pads[0], pads[0] + extra[0])
    if pooling_type == "max":
        if native:
            return F.max_pool2d(x, ksize, strides, pads)
        low = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        return F.max_pool2d(F.pad(x, explicit, value=low), ksize, strides)
    xf = x.float()
    padded = any(pads) or any(extra)
    if native:
        out = F.avg_pool2d(xf, ksize, strides, pads,
                           count_include_pad=not (exclusive and padded))
    else:
        summed = F.avg_pool2d(F.pad(xf, explicit), ksize, strides,
                              divisor_override=1)
        if exclusive and padded:
            ones = F.pad(torch.ones_like(xf[:1, :1]), explicit)
            out = summed / F.avg_pool2d(ones, ksize, strides,
                                        divisor_override=1)
        else:
            out = summed / float(ksize[0] * ksize[1])
    return out.to(x.dtype)


@register_op("pool2d")
def _pool2d_op(ctx, ins, attrs):
    return {"Out": _pool2d(
        ins["X"][0], attrs.get("pooling_type", "max"),
        _pair(attrs.get("ksize", [1, 1])), _pair(attrs.get("strides", [1, 1])),
        _pair(attrs.get("paddings", [0, 0])),
        attrs.get("global_pooling", False), attrs.get("ceil_mode", False),
        attrs.get("exclusive", True))}


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
        mean = torch.mean(xs, dim=axes)
        var = torch.mean(torch.square(xs), dim=axes) - torch.square(mean)
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
    # jax.random.bernoulli(key, 1 - p, shape): uniform bits < 1 - p
    keep = prng.uniform(ctx.next_key(), tuple(x.shape)) < (1.0 - p)
    mask = keep.to(x.dtype)
    return {"Out": x * mask, "Mask": mask}


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
    total = torch.tensor(label.shape[0], dtype=torch.int32,
                         device=indices.device)
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
    tpr = (above * pos).sum(1) / torch.clamp_min(pos.sum(), 1.0)
    fpr = (above * neg).sum(1) / torch.clamp_min(neg.sum(), 1.0)
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
