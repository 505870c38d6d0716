"""ResNet for ImageNet and CIFAR-10 (a copy of paddle_tpu/models/resnet.py
built on the port's fluid layers).

Parity: benchmark/paddle/image/resnet.py (the north-star ResNet-50
workload, BASELINE.md) and the book image_classification resnet_cifar10.
Bottleneck-v1 topology, NCHW, batch-norm after every conv.
"""

from __future__ import annotations

from ..fluid import layers

__all__ = ["resnet_imagenet", "resnet_cifar10"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu"):
    conv = layers.conv2d(
        input=input,
        num_filters=ch_out,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(input=conv, act=act)


def shortcut(input, ch_in, ch_out, stride):
    if ch_in != ch_out or stride != 1:
        return conv_bn_layer(input, ch_out, 1, stride, 0, act=None)
    return input


def basicblock(input, ch_in, ch_out, stride):
    short = shortcut(input, ch_in, ch_out, stride)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None)
    return layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_in, ch_out, stride):
    short = shortcut(input, ch_in, ch_out * 4, stride)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None)
    return layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_in, ch_out, count, stride):
    res_out = block_func(input, ch_in, ch_out, stride)
    ch_in = ch_out * 4 if block_func is bottleneck else ch_out
    for i in range(1, count):
        res_out = block_func(res_out, ch_in, ch_out, 1)
    return res_out


_IMAGENET_CFG = {
    18: (basicblock, [2, 2, 2, 2]),
    34: (basicblock, [3, 4, 6, 3]),
    50: (bottleneck, [3, 4, 6, 3]),
    101: (bottleneck, [3, 4, 23, 3]),
    152: (bottleneck, [3, 8, 36, 3]),
}


def resnet_imagenet(input, class_dim=1000, depth=50):
    """ResNet-{18,34,50,101,152} (benchmark/paddle/image/resnet.py layout)."""
    if depth not in _IMAGENET_CFG:
        raise ValueError("unsupported resnet depth %d" % depth)
    block_func, counts = _IMAGENET_CFG[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2, padding=3)
    pool1 = layers.pool2d(
        input=conv1, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"
    )
    ch_in = 64
    res = pool1
    for i, (count, ch_out) in enumerate(zip(counts, [64, 128, 256, 512])):
        stride = 1 if i == 0 else 2
        res = layer_warp(block_func, res, ch_in, ch_out, count, stride)
        ch_in = ch_out * 4 if block_func is bottleneck else ch_out
    pool2 = layers.pool2d(input=res, pool_size=7, pool_type="avg", global_pooling=True)
    return layers.fc(input=pool2, size=class_dim, act="softmax")


def resnet_cifar10(input, class_dim=10, depth=32):
    """CIFAR ResNet (book image_classification resnet_cifar10)."""
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input, ch_out=16, filter_size=3, stride=1, padding=1)
    res1 = layer_warp(basicblock, conv1, 16, 16, n, 1)
    res2 = layer_warp(basicblock, res1, 16, 32, n, 2)
    res3 = layer_warp(basicblock, res2, 32, 64, n, 2)
    pool = layers.pool2d(input=res3, pool_size=8, pool_type="avg", pool_stride=1)
    return layers.fc(input=pool, size=class_dim, act="softmax")
