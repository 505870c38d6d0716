"""GoogLeNet v1 (a copy of paddle_tpu/models/googlenet.py built on the
port's fluid layers; reference benchmark/paddle/image/googlenet.py,
1149 ms/batch at bs=128 on a K40m there; Inception-v1 topology with LRN,
no BN).

The two auxiliary softmax heads of the original paper are omitted, matching
the reference benchmark config (it trains the main head only).
"""

from __future__ import annotations

from ..fluid import layers

__all__ = ["googlenet"]


def _conv(input, num_filters, filter_size, stride=1, padding=0):
    return layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        act="relu",
    )


def inception(input, nf1, nf3r, nf3, nf5r, nf5, proj):
    t1 = _conv(input, nf1, 1)
    t3 = _conv(_conv(input, nf3r, 1), nf3, 3, padding=1)
    t5 = _conv(_conv(input, nf5r, 1), nf5, 5, padding=2)
    tp = layers.pool2d(
        input=input, pool_size=3, pool_stride=1, pool_padding=1, pool_type="max"
    )
    tp = _conv(tp, proj, 1)
    return layers.concat([t1, t3, t5, tp], axis=1)


def googlenet(input, class_dim=1000):
    net = _conv(input, 64, 7, stride=2, padding=3)
    net = layers.pool2d(
        input=net, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"
    )
    net = layers.lrn(input=net, n=5)
    net = _conv(net, 64, 1)
    net = _conv(net, 192, 3, padding=1)
    net = layers.lrn(input=net, n=5)
    net = layers.pool2d(
        input=net, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"
    )

    net = inception(net, 64, 96, 128, 16, 32, 32)
    net = inception(net, 128, 128, 192, 32, 96, 64)
    net = layers.pool2d(
        input=net, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"
    )
    net = inception(net, 192, 96, 208, 16, 48, 64)
    net = inception(net, 160, 112, 224, 24, 64, 64)
    net = inception(net, 128, 128, 256, 24, 64, 64)
    net = inception(net, 112, 144, 288, 32, 64, 64)
    net = inception(net, 256, 160, 320, 32, 128, 128)
    net = layers.pool2d(
        input=net, pool_size=3, pool_stride=2, pool_padding=1, pool_type="max"
    )
    net = inception(net, 256, 160, 320, 32, 128, 128)
    net = inception(net, 384, 192, 384, 48, 128, 128)
    net = layers.pool2d(input=net, pool_size=7, pool_type="avg", global_pooling=True)
    net = layers.dropout(x=net, dropout_prob=0.4)
    return layers.fc(input=net, size=class_dim, act="softmax")
