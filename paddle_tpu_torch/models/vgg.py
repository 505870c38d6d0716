"""VGG-16 and VGG-19 (a copy of paddle_tpu/models/vgg.py built on the
port's fluid layers; reference benchmark/cluster/vgg16/vgg16_fluid.py
and the book image_classification vgg16_bn_drop)."""

from __future__ import annotations

from ..fluid import layers, nets

__all__ = ["vgg16_bn_drop", "vgg16", "vgg19"]


def vgg16_bn_drop(input, class_dim=10):
    def conv_block(inp, num_filter, groups, dropouts):
        return nets.img_conv_group(
            input=inp,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts,
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = layers.dropout(x=conv5, dropout_prob=0.5)
    fc1 = layers.fc(input=drop, size=512, act=None)
    bn = layers.batch_norm(input=fc1, act="relu")
    drop2 = layers.dropout(x=bn, dropout_prob=0.5)
    fc2 = layers.fc(input=drop2, size=512, act=None)
    return layers.fc(input=fc2, size=class_dim, act="softmax")


def vgg19(input, class_dim=1000):
    """Plain VGG-19 without BN: the variant the reference's CPU
    benchmark tables use (benchmark/IntelOptimizedPaddle.md:29,71);
    same block layout as vgg16 with 4-conv deep blocks."""

    def conv_block(inp, num_filter, groups):
        return nets.img_conv_group(
            input=inp,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 4)
    conv4 = conv_block(conv3, 512, 4)
    conv5 = conv_block(conv4, 512, 4)
    fc1 = layers.fc(input=conv5, size=4096, act="relu")
    drop1 = layers.dropout(x=fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act="relu")
    drop2 = layers.dropout(x=fc2, dropout_prob=0.5)
    return layers.fc(input=drop2, size=class_dim, act="softmax")


def vgg16(input, class_dim=1000):
    """Plain VGG-16 without BN (benchmark/paddle/image/vgg.py layout)."""

    def conv_block(inp, num_filter, groups):
        return nets.img_conv_group(
            input=inp,
            pool_size=2,
            pool_stride=2,
            conv_num_filter=[num_filter] * groups,
            conv_filter_size=3,
            conv_act="relu",
            pool_type="max",
        )

    conv1 = conv_block(input, 64, 2)
    conv2 = conv_block(conv1, 128, 2)
    conv3 = conv_block(conv2, 256, 3)
    conv4 = conv_block(conv3, 512, 3)
    conv5 = conv_block(conv4, 512, 3)
    fc1 = layers.fc(input=conv5, size=4096, act="relu")
    drop1 = layers.dropout(x=fc1, dropout_prob=0.5)
    fc2 = layers.fc(input=drop1, size=4096, act="relu")
    drop2 = layers.dropout(x=fc2, dropout_prob=0.5)
    return layers.fc(input=drop2, size=class_dim, act="softmax")
