"""SSD single-shot detector (a copy of paddle_tpu/models/ssd.py built on
the port's fluid layers; reference capability: the gserver SSD stack,
PriorBoxLayer.cpp, MultiBoxLossLayer.cpp and DetectionOutputLayer.cpp).
A small conv backbone, two detection feature maps, per-map loc/conf
conv heads, prior boxes concatenated across maps, trained with ssd_loss
and served through detection_output (decode + multiclass NMS).

Everything is static-shape: priors per image are fixed by the feature
map geometry, and ground truth rides packed [G, 4] + LoD exactly like
every other ragged feed.
"""

from __future__ import annotations

from ..fluid import layers

__all__ = ["ssd_lite", "ssd_detector"]


def _backbone(image):
    """Three conv stages; returns the two detection feature maps."""
    c1 = layers.conv2d(
        input=image, num_filters=16, filter_size=3, padding=1, act="relu"
    )
    p1 = layers.pool2d(input=c1, pool_size=2, pool_stride=2)
    c2 = layers.conv2d(
        input=p1, num_filters=32, filter_size=3, padding=1, act="relu"
    )
    p2 = layers.pool2d(input=c2, pool_size=2, pool_stride=2)  # stride 4
    c3 = layers.conv2d(
        input=p2, num_filters=64, filter_size=3, padding=1, act="relu"
    )
    p3 = layers.pool2d(input=c3, pool_size=2, pool_stride=2)  # stride 8
    return p2, p3


def _head(feat, n_priors, num_classes, batch):
    """Loc + conf conv heads over one feature map, flattened to
    [N, HW*priors, 4] / [N, HW*priors, C]."""
    loc = layers.conv2d(
        input=feat, num_filters=n_priors * 4, filter_size=3, padding=1
    )
    conf = layers.conv2d(
        input=feat, num_filters=n_priors * num_classes, filter_size=3,
        padding=1,
    )
    h, w = feat.shape[2], feat.shape[3]

    def _flat(t, last):
        t = layers.transpose(t, [0, 2, 3, 1])
        return layers.reshape(t, [batch, int(h) * int(w) * n_priors, last])

    return _flat(loc, 4), _flat(conf, num_classes)


def ssd_lite(image, num_classes, image_size, batch, min_sizes=(0.2, 0.45)):
    """Build the SSD graph over `image` [N,3,S,S].

    Returns (loc [N,P,4], conf [N,P,C], priors [P,4], prior_vars [P,4]).
    """
    f1, f2 = _backbone(image)
    heads, priors, prior_vars = [], [], []
    for feat, ms in ((f1, min_sizes[0]), (f2, min_sizes[1])):
        # priors per location: min_size x {1, 2, 1/2 aspect} = 3
        box, var = layers.prior_box(
            input=feat,
            image=image,
            min_sizes=[ms * image_size],
            aspect_ratios=[2.0],
            flip=True,
            clip=True,
            variance=[0.1, 0.1, 0.2, 0.2],
        )
        n_priors = int(box.shape[2])  # [H, W, P, 4] static layer shape
        loc, conf = _head(feat, n_priors, num_classes, batch)
        heads.append((loc, conf))
        priors.append(layers.reshape(box, [-1, 4]))
        prior_vars.append(layers.reshape(var, [-1, 4]))
    loc = layers.concat([h[0] for h in heads], axis=1)
    conf = layers.concat([h[1] for h in heads], axis=1)
    pb = layers.concat(priors, axis=0)
    pbv = layers.concat(prior_vars, axis=0)
    return loc, conf, pb, pbv


def ssd_detector(image, gt_box, gt_label, num_classes, image_size, batch):
    """Training head: per-image multibox loss (mean over the batch) plus
    the eval detections [label, score, x1, y1, x2, y2]."""
    loc, conf, pb, pbv = ssd_lite(image, num_classes, image_size, batch)
    cost = layers.ssd_loss(
        location=loc, confidence=conf, gt_box=gt_box, gt_label=gt_label,
        prior_box=pb, prior_box_var=pbv,
    )
    avg_cost = layers.mean(x=cost)
    # class probabilities: softmax over the CLASS dim of [N, P, C], then
    # to the [N, C, P] layout multiclass_nms consumes
    scores = layers.transpose(layers.softmax(conf), [0, 2, 1])
    detections = layers.detection_output(
        scores=scores, loc=loc, prior_box=pb, prior_box_var=pbv,
        score_threshold=0.1, nms_threshold=0.45, keep_top_k=8,
    )
    return avg_cost, detections
