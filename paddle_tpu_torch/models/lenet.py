"""MNIST conv net and MLP (a copy of paddle_tpu/models/lenet.py built on
the port's fluid layers; reference book test recognize_digits:
python/paddle/v2/fluid/tests/book/test_recognize_digits.py)."""

from __future__ import annotations

from ..fluid import layers, nets


def lenet(images, class_dim=10):
    """conv-pool x2 + fc softmax head, NCHW [N,1,28,28]."""
    conv_pool_1 = nets.simple_img_conv_pool(
        input=images,
        filter_size=5,
        num_filters=20,
        pool_size=2,
        pool_stride=2,
        act="relu",
    )
    conv_pool_2 = nets.simple_img_conv_pool(
        input=conv_pool_1,
        filter_size=5,
        num_filters=50,
        pool_size=2,
        pool_stride=2,
        act="relu",
    )
    return layers.fc(input=conv_pool_2, size=class_dim, act="softmax")


def mlp(images, class_dim=10):
    """3-layer MLP head (reference recognize_digits_mlp)."""
    hidden1 = layers.fc(input=images, size=128, act="relu")
    hidden2 = layers.fc(input=hidden1, size=64, act="relu")
    return layers.fc(input=hidden2, size=class_dim, act="softmax")
