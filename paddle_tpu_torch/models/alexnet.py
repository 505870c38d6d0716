"""AlexNet (a copy of paddle_tpu/models/alexnet.py built on the port's
fluid layers; reference benchmark/paddle/image/alexnet.py, the headline
benchmark model in benchmark/README.md:37)."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["alexnet"]


def alexnet(input, class_dim=1000):
    conv1 = layers.conv2d(
        input=input, num_filters=64, filter_size=11, stride=4, padding=2, act="relu"
    )
    pool1 = layers.pool2d(input=conv1, pool_size=3, pool_stride=2, pool_type="max")
    conv2 = layers.conv2d(input=pool1, num_filters=192, filter_size=5, padding=2, act="relu")
    pool2 = layers.pool2d(input=conv2, pool_size=3, pool_stride=2, pool_type="max")
    conv3 = layers.conv2d(input=pool2, num_filters=384, filter_size=3, padding=1, act="relu")
    conv4 = layers.conv2d(input=conv3, num_filters=256, filter_size=3, padding=1, act="relu")
    conv5 = layers.conv2d(input=conv4, num_filters=256, filter_size=3, padding=1, act="relu")
    pool5 = layers.pool2d(input=conv5, pool_size=3, pool_stride=2, pool_type="max")
    fc6 = layers.fc(input=pool5, size=4096, act="relu")
    drop6 = layers.dropout(x=fc6, dropout_prob=0.5)
    fc7 = layers.fc(input=drop6, size=4096, act="relu")
    drop7 = layers.dropout(x=fc7, dropout_prob=0.5)
    return layers.fc(input=drop7, size=class_dim, act="softmax")
