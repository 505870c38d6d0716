"""Detection layers (a copy of paddle_tpu/fluid/layers/detection.py;
reference python/paddle/v2/fluid/layers/detection.py detection_output:23,
plus thin wrappers over the detection op kernels,
core/kernels_detection.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "detection_output",
    "prior_box",
    "box_coder",
    "bipartite_match",
    "multiclass_nms",
]


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    helper = LayerHelper("box_coder", **locals())
    output_box = helper.create_tmp_variable(dtype=target_box.dtype)
    helper.append_op(
        type="box_coder",
        inputs={
            "PriorBox": [prior_box],
            "PriorBoxVar": [prior_box_var],
            "TargetBox": [target_box],
        },
        outputs={"OutputBox": [output_box]},
        attrs={"code_type": code_type},
    )
    return output_box


def multiclass_nms(scores, bboxes, background_label=0, score_threshold=0.01,
                   nms_top_k=400, nms_threshold=0.3, keep_top_k=200,
                   nms_eta=1.0, name=None):
    helper = LayerHelper("multiclass_nms", **locals())
    out = helper.create_tmp_variable(dtype=bboxes.dtype)
    out.lod_level = 1
    helper.append_op(
        type="multiclass_nms",
        inputs={"Scores": [scores], "BBoxes": [bboxes]},
        outputs={"Out": [out]},
        attrs={
            "background_label": background_label,
            "score_threshold": score_threshold,
            "nms_top_k": nms_top_k,
            "nms_threshold": nms_threshold,
            "keep_top_k": keep_top_k,
            "nms_eta": nms_eta,
        },
    )
    return out


def detection_output(scores, loc, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode predicted offsets against priors, then multiclass NMS
    (reference detection.py:23). Output rows are
    [label, confidence, xmin, ymin, xmax, ymax], padded per image with -1
    rows to keep_top_k; per-image valid counts ride the LoD side-band."""
    decoded = box_coder(
        prior_box=prior_box,
        prior_box_var=prior_box_var,
        target_box=loc,
        code_type="decode_center_size",
    )
    return multiclass_nms(
        scores=scores,
        bboxes=decoded,
        background_label=background_label,
        score_threshold=score_threshold,
        nms_top_k=nms_top_k,
        nms_threshold=nms_threshold,
        keep_top_k=keep_top_k,
        nms_eta=nms_eta,
    )


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=None,
              variance=None, flip=False, clip=False, step_w=0.0, step_h=0.0,
              offset=0.5, name=None):
    helper = LayerHelper("prior_box", **locals())
    # static output shape [H, W, P, 4]: P follows the kernel's anchor
    # count — per min_size: {1} u aspects(x2 if flip), plus ONE
    # sqrt(min*max) box when max_sizes are given (kernel pairs them
    # per min_size)
    n_ar = 1 + len(aspect_ratios or []) * (2 if flip else 1)
    n_priors = len(min_sizes) * (n_ar + (1 if max_sizes else 0))
    h = input.shape[2] if input.shape and len(input.shape) == 4 else None
    w = input.shape[3] if input.shape and len(input.shape) == 4 else None
    out_shape = (
        (int(h), int(w), n_priors, 4) if h and w else None
    )
    boxes = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    variances = helper.create_tmp_variable(dtype=input.dtype, shape=out_shape)
    helper.append_op(
        type="prior_box",
        inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={
            "min_sizes": list(min_sizes),
            "max_sizes": list(max_sizes or []),
            "aspect_ratios": list(aspect_ratios or []),
            "variances": list(variance or [0.1, 0.1, 0.2, 0.2]),
            "flip": flip,
            "clip": clip,
            "step_w": step_w,
            "step_h": step_h,
            "offset": offset,
        },
    )
    return boxes, variances


def bipartite_match(dist_matrix, name=None):
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_tmp_variable(dtype="int32")
    match_dist = helper.create_tmp_variable(dtype=dist_matrix.dtype)
    helper.append_op(
        type="bipartite_match",
        inputs={"DistMat": [dist_matrix]},
        outputs={
            "ColToRowMatchIndices": [match_indices],
            "ColToRowMatchDist": [match_dist],
        },
    )
    return match_indices, match_dist


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var, overlap_threshold=0.5, neg_pos_ratio=3.0,
             neg_overlap=0.5, background_label=0, name=None, **kwargs):
    """SSD MultiBox training loss (legacy gserver MultiBoxLossLayer.cpp).
    location [N,P,4], confidence [N,P,C], gt_box packed [G,4] with a LoD
    mapping boxes to images, gt_label packed [G,1]. Returns a per-image
    cost [N, 1]."""
    helper = LayerHelper("ssd_multibox_loss", **locals())
    out = helper.create_tmp_variable(dtype=location.dtype)
    helper.append_op(
        type="ssd_multibox_loss",
        inputs={
            "Loc": [location], "Conf": [confidence],
            "GTBox": [gt_box], "GTLabel": [gt_label],
            "PriorBox": [prior_box], "PriorVar": [prior_box_var],
        },
        outputs={"Out": [out]},
        attrs={
            "overlap_threshold": overlap_threshold,
            "neg_pos_ratio": neg_pos_ratio,
            "neg_overlap": neg_overlap,
            "background_id": background_label,
        },
    )
    return out


__all__.append("ssd_loss")
