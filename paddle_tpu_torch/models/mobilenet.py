"""MobileNet v1 (a copy of paddle_tpu/models/mobilenet.py built on the
port's fluid layers): depthwise-separable convolutions, the reference's
paddle/function/DepthwiseConvOp*.cpp, as cuDNN grouped convolutions with
groups = channels."""

from __future__ import annotations

from ..fluid import layers

__all__ = ["mobilenet_v1"]


def _conv_bn(input, num_filters, filter_size, stride, padding, channels,
             groups=1):
    conv = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        groups=groups,
        num_channels=channels,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(input=conv, act="relu")


def _depthwise_separable(input, channels, filters, stride, scale=1.0):
    ch = int(channels * scale)
    nf = int(filters * scale)
    # depthwise: groups == in channels
    dw = _conv_bn(input, ch, 3, stride, 1, channels=ch, groups=ch)
    # pointwise 1x1 mixes channels
    return _conv_bn(dw, nf, 1, 1, 0, channels=ch)


def mobilenet_v1(input, class_dim=1000, scale=1.0):
    """Standard 224x224 MobileNet v1 at width multiplier `scale`."""
    s = lambda n: int(n * scale)
    y = _conv_bn(input, s(32), 3, 2, 1, channels=int(input.shape[1]))
    cfg = [
        # (in, out, stride)
        (32, 64, 1),
        (64, 128, 2),
        (128, 128, 1),
        (128, 256, 2),
        (256, 256, 1),
        (256, 512, 2),
        (512, 512, 1),
        (512, 512, 1),
        (512, 512, 1),
        (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2),
        (1024, 1024, 1),
    ]
    for cin, cout, stride in cfg:
        y = _depthwise_separable(y, cin, cout, stride, scale)
    y = layers.pool2d(input=y, pool_type="avg", global_pooling=True)
    return layers.fc(input=y, size=class_dim, act="softmax")
