"""ResNet v1 with bottleneck blocks in plain PyTorch float32: the
reference of the `resnet50_imagenet` configuration (He et al. 2015, as
the reference repository's benchmark/paddle/image/resnet.py lays it
out). It imports nothing of the program.

NCHW. Every convolution has no bias and is followed by batch
normalisation in training mode (the batch's mean and biased variance,
eps 1e-5), then ReLU except where a residual sum follows. A block's
first 1x1 convolution carries its stride; a projection shortcut (1x1
convolution and batch norm) where the width or the stride changes. Stem:
7x7/2 convolution, 3x3/2 max pool (padding 1); head: global average
pool, a fully connected layer with bias, softmax; the loss is the mean
of -log p(label). Momentum SGD: v <- mu v + g, p <- p - lr v.

`layout` lists the leaves in the order the configuration's program
creates its parameters, which is the order the benchmark hands weights
to both sides. `conv` and `mm` swap the convolution and the matrix
product, and `act` is applied to every stored activation (the outputs of
the convolutions, batch norms, ReLUs, sums, pools, the fc layer and the
softmax): the control passes fp8 ones. TF32 is off."""

import torch
import torch.nn.functional as F

STAGES = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
WIDTHS = [64, 128, 256, 512]


def _conv(c_out, c_in, k, stride, pad):
    return [{"kind": "conv", "shape": (c_out, c_in, k, k), "stride": stride,
             "pad": pad},
            {"kind": "bn_scale", "shape": (c_out,)},
            {"kind": "bn_bias", "shape": (c_out,)}]


def layout(depth=50, classes=1000):
    """[{"kind", "shape", ...}] in parameter-creation order."""
    out = _conv(64, 3, 7, 2, 3)
    c_in = 64
    for i, (count, w) in enumerate(zip(STAGES[depth], WIDTHS)):
        for b in range(count):
            s = (1 if i == 0 else 2) if b == 0 else 1
            if c_in != 4 * w or s != 1:
                out += _conv(4 * w, c_in, 1, s, 0)
            out += _conv(w, c_in, 1, s, 0) + _conv(w, w, 3, 1, 1) + \
                _conv(4 * w, w, 1, 1, 0)
            c_in = 4 * w
    return out + [{"kind": "fc_w", "shape": (c_in, classes)},
                  {"kind": "fc_b", "shape": (classes,)}]


def _bn(x, g, b):
    mean = x.mean((0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + 1e-5) * g.view(1, -1, 1, 1) + \
        b.view(1, -1, 1, 1)


def _same(x):
    return x


def probs(lay, ws, x, depth=50, conv=F.conv2d, mm=torch.matmul,
          act=_same):
    """Softmax outputs [N, classes] of images x [N, 3, H, W]."""
    it = iter(zip(lay, ws))

    def conv_bn(h, relu):
        (spec, w), (_, g), (_, b) = next(it), next(it), next(it)
        y = act(_bn(act(conv(h, w, spec["stride"], spec["pad"])), g, b))
        return act(F.relu(y)) if relu else y

    h = act(F.max_pool2d(conv_bn(x, True), 3, 2, 1))
    c_in = 64
    for i, (count, w) in enumerate(zip(STAGES[depth], WIDTHS)):
        for b in range(count):
            s = (1 if i == 0 else 2) if b == 0 else 1
            short = conv_bn(h, False) if (c_in != 4 * w or s != 1) else h
            y = conv_bn(conv_bn(conv_bn(h, True), True), False)
            h = act(F.relu(act(short + y)))
            c_in = 4 * w
    h = act(h.mean((2, 3)))
    (_, fw), (_, fb) = next(it), next(it)
    return act(torch.softmax(act(act(mm(h, fw)) + fb), dim=-1))


def _f32_conv(x, w, stride, pad):
    return F.conv2d(x, w, None, stride, pad)


def train_readings(lay, ws, batches, lr, mu, depth=50, conv=_f32_conv,
                   mm=torch.matmul, act=_same):
    """Readings of len(batches) Momentum steps from weights `ws` over
    batches [(images, labels [N, 1])]: {"loss": [per step], "grad_norms":
    [per leaf, the velocity after the first step], "change_norms": [per
    leaf]}."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        p = [w.detach().clone() for w in ws]
        p0 = [w.clone() for w in p]
        vel = [torch.zeros_like(w) for w in p]
        losses, grad_norms = [], None
        for k, (img, lab) in enumerate(batches):
            leaves = [w.requires_grad_(True) for w in
                      (x.detach() for x in p)]
            pr = probs(lay, leaves, act(img.to(p[0].dtype)), depth, conv, mm,
                       act)
            loss = -torch.log(pr.gather(1, lab.long().view(-1, 1))).mean()
            grads = torch.autograd.grad(loss, leaves)
            losses.append(float(loss.detach()))
            del pr, loss, leaves
            with torch.no_grad():
                for x, v, g in zip(p, vel, grads):
                    v.mul_(mu).add_(g)
                    x.sub_(lr * v)
            del grads
            if k == 0:
                grad_norms = torch.stack([v.norm() for v in vel])
        change = torch.stack([(b - a).norm() for a, b in zip(p0, p)])
        return {"loss": losses, "grad_norms": grad_norms,
                "change_norms": change}
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
