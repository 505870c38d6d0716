"""Predefined networks for image classification (reference
python/paddle/utils/predefined_net.py). The originals were written in
the pre-DSL v1 config idiom (`img_conv_bn_pool`, `Settings`,
`end_of_network`); here they build through the trainer_config_helpers
DSL — same topologies, same entry points, modern config plumbing."""

from __future__ import annotations

import os

import numpy as np

from .. import trainer_config_helpers as tch

__all__ = [
    "image_data", "get_extra_layer_attr", "image_data_layers",
    "simple_conv_net", "vgg_conv_net", "vgg16_conv_net", "small_vgg",
    "training_settings",
]


def image_data(data_dir, processed_image_size, overwrite=False, color=True,
               train_list="batches/train.list",
               test_list="batches/test.list",
               meta_file="batches/batches.meta", use_jpeg=1):
    """Declare the batched image dataset written by
    ImageClassificationDatasetCreater as this config's data source."""
    import pickle

    meta_path = os.path.join(data_dir, meta_file)
    with open(meta_path, "rb") as f:
        conf = pickle.load(f)
    args = {
        "meta": meta_path,
        "mean_img_size": conf["mean_image_size"],
        "img_size": processed_image_size,
        "num_classes": conf["num_classes"],
        "use_jpeg": use_jpeg != 0,
        "color": "color" if conf["color"] else "gray",
    }
    tch.define_py_data_sources2(
        os.path.join(data_dir, train_list),
        os.path.join(data_dir, test_list),
        module="image_provider",
        obj="processData",
        args=args,
    )
    return {
        "image_size": processed_image_size,
        "num_classes": conf["num_classes"],
        "is_color": conf["color"],
    }


def get_extra_layer_attr(drop_rate):
    if not drop_rate:
        return None
    return tch.ExtraLayerAttribute(drop_rate=drop_rate)


def image_data_layers(image_size, num_classes, is_color=False,
                      is_predict=False):
    """The input(+label) data layers of an image classifier."""
    channels = 3 if is_color else 1
    data_input = tch.data_layer("input", image_size * image_size * channels)
    if is_predict:
        return data_input, None, channels
    label_input = tch.data_layer("label", 1)
    return data_input, label_input, channels


def _conv_bn_pool(name, input, filter_size, num_channel, num_filters):
    conv = tch.img_conv_layer(
        input=input, filter_size=filter_size, num_channels=num_channel,
        num_filters=num_filters, stride=1, padding=0,
        act=tch.LinearActivation(), name="%s_conv" % name,
    )
    bn = tch.batch_norm_layer(
        input=conv, act=tch.ReluActivation(), name="%s_bn" % name
    )
    return tch.img_pool_layer(
        input=bn, pool_size=3, stride=2, name="%s_pool" % name
    )


def simple_conv_net(data_conf, is_color=False, is_predict=False):
    """Two conv+bn+pool groups, one hidden fc with dropout, softmax
    output (the reference's MNIST-scale net)."""
    image_size = data_conf["image_size"]
    num_classes = data_conf["num_classes"]
    data_input, label_input, channels = image_data_layers(
        image_size, num_classes, is_color, is_predict
    )
    g1 = _conv_bn_pool("g1", data_input, 5, channels, 32)
    g2 = _conv_bn_pool("g2", g1, 5, 32, 64)
    fc3 = tch.fc_layer(
        input=g2, size=500, act=tch.ReluActivation(), name="fc3"
    )
    fc3_dropped = tch.dropout_layer(input=fc3, dropout_rate=0.5)
    output = tch.fc_layer(
        input=fc3_dropped, size=num_classes,
        act=tch.SoftmaxActivation(), name="output",
    )
    if is_predict:
        tch.outputs(output)
        return output
    cost = tch.classification_cost(input=output, label=label_input)
    tch.outputs(cost)
    return cost


def _vgg_group(name, input, num_channel, num_filters, n_convs, drop_rate):
    h = input
    for i in range(n_convs):
        h = tch.img_conv_layer(
            input=h, filter_size=3, padding=1,
            num_channels=num_channel if i == 0 else num_filters,
            num_filters=num_filters, act=tch.ReluActivation(),
            name="%s_conv%d" % (name, i),
            layer_attr=get_extra_layer_attr(drop_rate),
        )
    return tch.img_pool_layer(
        input=h, pool_size=2, stride=2, name="%s_pool" % name
    )


def vgg_conv_net(image_size, num_classes, num_layers, is_color=False,
                 is_predict=False):
    """VGG-style stack: conv groups doubling channels, two dropout fc
    layers, softmax output. num_layers 16 -> groups (2,2,3,3,3)."""
    depth_conf = {
        11: (1, 1, 2, 2, 2),
        13: (2, 2, 2, 2, 2),
        16: (2, 2, 3, 3, 3),
        19: (2, 2, 4, 4, 4),
    }
    groups = depth_conf.get(num_layers)
    if groups is None:
        raise ValueError("unsupported vgg depth %r" % num_layers)
    data_input, label_input, channels = image_data_layers(
        image_size, num_classes, is_color, is_predict
    )
    h = data_input
    filters = [64, 128, 256, 512, 512]
    ch = channels
    for gi, (n_convs, nf) in enumerate(zip(groups, filters)):
        h = _vgg_group("vgg_g%d" % gi, h, ch, nf, n_convs,
                       0.0 if gi < 2 else 0.1)
        ch = nf
    fc1 = tch.fc_layer(input=h, size=512, act=tch.ReluActivation())
    fc1 = tch.dropout_layer(input=fc1, dropout_rate=0.5)
    fc2 = tch.fc_layer(input=fc1, size=512, act=tch.ReluActivation())
    fc2 = tch.dropout_layer(input=fc2, dropout_rate=0.5)
    output = tch.fc_layer(
        input=fc2, size=num_classes, act=tch.SoftmaxActivation(),
        name="output",
    )
    if is_predict:
        tch.outputs(output)
        return output
    cost = tch.classification_cost(input=output, label=label_input)
    tch.outputs(cost)
    return cost


def vgg16_conv_net(image_size, num_classes, is_color=True,
                   is_predict=False):
    return vgg_conv_net(image_size, num_classes, 16, is_color, is_predict)


def small_vgg(data_conf, is_predict=False):
    """VGG-11 at dataset scale (the reference's CIFAR-sized variant)."""
    return vgg_conv_net(
        data_conf["image_size"], data_conf["num_classes"], 11,
        data_conf.get("is_color", True), is_predict,
    )


def training_settings(learning_rate=0.1, batch_size=128, algorithm="sgd",
                      momentum=0.9, decay_rate=0.001):
    """The reference's standard optimization settings block."""
    tch.settings(
        batch_size=batch_size,
        learning_rate=learning_rate / float(batch_size),
        learning_method=tch.MomentumOptimizer(momentum)
        if algorithm == "sgd"
        else {
            "adagrad": tch.AdaGradOptimizer(),
            "adadelta": tch.AdaDeltaOptimizer(),
            "rmsprop": tch.RMSPropOptimizer(),
        }[algorithm],
        regularization=tch.L2Regularization(decay_rate * batch_size),
    )
