"""Detection op kernels: prior_box, box_coder, bipartite_match,
multiclass_nms, roi_pool, ssd_multibox_loss, detection_map, pnpair_eval
(counterpart of paddle_tpu/fluid/core/kernels_detection.py, as plain
torch ops).

Everything keeps static shapes and stays on the device: NMS's
data-dependent output count becomes a fixed [N*keep_top_k, 6] buffer,
valid rows first, with device-side per-image counts riding the LoD
side-band (no host copy) and the pad stride under "<out>@PAD_STRIDE",
the convention beam search decode uses (kernels_control.py). The greedy
scans (bipartite matching, NMS suppression, SSD's prior claiming) are
Python loops of device ops with a fixed trip count; none of them calls
`nonzero`, a boolean-mask index or `.item()`. Sorts that the JAX package
takes from `jnp.argsort` (stable) are `torch.argsort(stable=True)`, and
`lax.top_k` is `kernels_nn.stable_topk` (ties at the lowest index).

Parity: reference operators/prior_box_op.h, box_coder_op.h,
bipartite_match_op.cc, multiclass_nms_op.cc, the legacy gserver
PriorBox / MultiBoxLoss / DetectionOutput / ROIPool layers and the
DetectionMAP and Pnpair evaluators.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .kernels_control import to_device_async
from .kernels_nn import stable_topk
from .kernels_sequence import PAD_STRIDE, lod_key, seg_ids
from .registry import register_op

_NEG = -1e30


def _at(x, i):
    """x[i] for a 1-element index tensor `i` along dim 0, kept [1, ...]
    (a gather: indexing with a 0-dim tensor could read it back)."""
    return x.index_select(0, i.reshape(1))


@register_op("prior_box")
def _prior_box(ctx, ins, attrs):
    """Anchor generation over a feature map (prior_box_op.h). The boxes
    depend only on shapes and attributes: they are computed on the host
    in float32 and go to the device in one non-blocking copy."""
    feat = ins["Input"][0]  # [N, C, H, W]
    image = ins["Image"][0]  # [N, C, Him, Wim]
    H, W = feat.shape[2], feat.shape[3]
    img_h, img_w = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", []):
        ars.append(float(ar))
        if attrs.get("flip", False):
            ars.append(1.0 / float(ar))
    variances = [float(v) for v in attrs.get("variances",
                                             [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or float(img_w) / W
    step_h = float(attrs.get("step_h", 0.0)) or float(img_h) / H
    offset = float(attrs.get("offset", 0.5))

    wh = []
    for ms in min_sizes:
        for ar in ars:
            wh.append((ms * math.sqrt(ar), ms / math.sqrt(ar)))
        if max_sizes:
            mx = max_sizes[min_sizes.index(ms)]
            wh.append((math.sqrt(ms * mx), math.sqrt(ms * mx)))
    P = len(wh)
    f32 = np.float32
    whs = np.asarray(wh, f32)  # [P, 2]
    cx = (np.arange(W, dtype=f32) + f32(offset)) * f32(step_w)
    cy = (np.arange(H, dtype=f32) + f32(offset)) * f32(step_h)
    cxg, cyg = np.meshgrid(cx, cy)  # [H, W]
    c = np.stack([cxg, cyg], axis=-1)[:, :, None, :]  # [H, W, 1, 2]
    half = whs[None, None, :, :] / f32(2.0)
    size = np.asarray([img_w, img_h], f32)
    boxes = np.concatenate([(c - half) / size, (c + half) / size], axis=-1)
    if attrs.get("clip", False):
        boxes = np.clip(boxes, f32(0.0), f32(1.0))
    var = np.broadcast_to(np.asarray(variances, f32), (H, W, P, 4))
    host = np.stack([boxes, var]).astype(f32)
    both = to_device_async(torch.from_numpy(host), feat.device)
    return {"Boxes": both[0], "Variances": both[1]}


@register_op("box_coder")
def _box_coder(ctx, ins, attrs):
    """Center-size encode/decode (box_coder_op.h)."""
    prior = ins["PriorBox"][0]  # [M, 4] xyxy
    pvar = ins["PriorBoxVar"][0] if ins.get("PriorBoxVar") \
        else torch.ones_like(prior)  # [M, 4]
    target = ins["TargetBox"][0]
    code = attrs.get("code_type", "encode_center_size")

    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + pw / 2
    pcy = prior[:, 1] + ph / 2
    if code == "encode_center_size":
        # target: [M, 4] gt boxes (broadcast against priors row-wise)
        tw = target[..., 2] - target[..., 0]
        th = target[..., 3] - target[..., 1]
        tcx = target[..., 0] + tw / 2
        tcy = target[..., 1] + th / 2
        out = torch.stack([
            (tcx - pcx) / pw / pvar[:, 0],
            (tcy - pcy) / ph / pvar[:, 1],
            torch.log(torch.clamp_min(tw / pw, 1e-12)) / pvar[:, 2],
            torch.log(torch.clamp_min(th / ph, 1e-12)) / pvar[:, 3],
        ], dim=-1)
    else:  # decode_center_size; target [N, M, 4] offsets
        dcx = target[..., 0] * pvar[:, 0] * pw + pcx
        dcy = target[..., 1] * pvar[:, 1] * ph + pcy
        dw = torch.exp(target[..., 2] * pvar[:, 2]) * pw
        dh = torch.exp(target[..., 3] * pvar[:, 3]) * ph
        out = torch.stack([dcx - dw / 2, dcy - dh / 2, dcx + dw / 2,
                           dcy + dh / 2], dim=-1)
    return {"OutputBox": out}


@register_op("bipartite_match")
def _bipartite_match(ctx, ins, attrs):
    """Greedy bipartite matching on a [N, M] distance matrix
    (bipartite_match_op.cc BipartiteMatch): min(N, M) rounds, each taking
    the global maximum (the first in row-major order on ties) and binding
    its row to its column."""
    if lod_key(ctx.op.inputs["DistMat"][0]) in ctx.env:
        raise NotImplementedError(
            "ragged bipartite_match batches: feed one instance per run "
            "or a dense [N, M] matrix for now")
    d = ins["DistMat"][0].float()
    N, M = d.shape
    dev = d.device
    rows = torch.arange(N, device=dev)
    cols = torch.arange(M, device=dev)
    row_of_col = torch.full((M,), -1, dtype=torch.int32, device=dev)
    dist_of_col = torch.zeros(M, device=dev)
    neg = torch.full_like(d, _NEG)
    for _ in range(min(N, M)):
        flat = torch.argmax(d).reshape(1)
        i, j = flat // M, flat % M
        best = d.reshape(-1).index_select(0, flat)
        valid = best > _NEG
        at_j = valid & (cols == j)
        row_of_col = torch.where(at_j, i.to(torch.int32), row_of_col)
        dist_of_col = torch.where(at_j, best, dist_of_col)
        hit = (rows == i)[:, None] | (cols == j)[None, :]
        d = torch.where(valid & hit, neg, d)
    return {"ColToRowMatchIndices": row_of_col.reshape(1, M),
            "ColToRowMatchDist": dist_of_col.reshape(1, M)}


def _iou(boxes):
    """Pairwise IoU of [..., M, 4] xyxy boxes -> [..., M, M]."""
    area = torch.clamp_min(boxes[..., 2] - boxes[..., 0], 0) * \
        torch.clamp_min(boxes[..., 3] - boxes[..., 1], 0)
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0)
    inter = wh[..., 0] * wh[..., 1]
    union = area[..., :, None] + area[..., None, :] - inter
    return inter / torch.clamp_min(union, 1e-12)


def _nms_keep(top_s, iou, nms_threshold):
    """Greedy NMS over candidates sorted by score, all images and classes
    at once: [..., K] scores (masked ones at _NEG), [..., K, K] IoU ->
    kept [..., K] bool. The JAX package's scan takes, K times, the best
    remaining candidate; with the scores sorted that is the first
    remaining position, so one pass over the positions in order keeps a
    candidate unless a kept earlier one overlaps it past the threshold."""
    over = iou > nms_threshold
    valid = top_s > _NEG
    suppressed = torch.zeros_like(valid)
    kept = []
    for p in range(top_s.shape[-1]):
        keep = valid[..., p] & ~suppressed[..., p]
        suppressed = suppressed | (keep[..., None] & over[..., p, :])
        kept.append(keep)
    return torch.stack(kept, dim=-1)


@register_op("multiclass_nms")
def _multiclass_nms(ctx, ins, attrs):
    """Per-class NMS + cross-class keep_top_k (multiclass_nms_op.cc).
    Output: [N*keep_top_k, 6] rows = [label, score, x1, y1, x2, y2],
    valid-first per image, per-image counts in the LoD side-band."""
    scores = ins["Scores"][0]  # [N, C, M]
    bboxes = ins["BBoxes"][0]  # [N, M, 4]
    N, C, M = scores.shape
    bg = int(attrs.get("background_label", 0))
    score_thresh = float(attrs.get("score_threshold", 0.01))
    nms_thresh = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 200))
    if keep_top_k < 0:
        keep_top_k = C * M
    # per class, sort by score and cap at nms_top_k BEFORE suppression:
    # the IoU block is [N, C, K, K], never [M, M]
    K = min(nms_top_k, M) if nms_top_k > 0 else M
    s = torch.where(scores > score_thresh, scores,
                    torch.full_like(scores, _NEG))
    top_s, top_i = stable_topk(s, K)  # [N, C, K]
    cand = torch.gather(bboxes[:, None].expand(N, C, M, 4), 2,
                        top_i[..., None].expand(N, C, K, 4))
    kept = _nms_keep(top_s, _iou(cand), nms_thresh)
    per_class = torch.full_like(s, _NEG).scatter(
        2, top_i, torch.where(kept, top_s, torch.full_like(top_s, _NEG)))
    if 0 <= bg < C:
        is_bg = (torch.arange(C, device=s.device) == bg)[None, :, None]
        per_class = torch.where(is_bg, torch.full_like(per_class, _NEG),
                                per_class)
    k = min(keep_top_k, C * M)
    top_s, top_i = stable_topk(per_class.reshape(N, C * M), k)  # [N, k]
    box = torch.gather(bboxes, 1, (top_i % M)[..., None].expand(N, k, 4))
    valid = top_s > _NEG
    rows = torch.cat([(top_i // M).to(top_s.dtype)[..., None],
                      top_s[..., None], box], dim=-1)  # [N, k, 6]
    rows = torch.where(valid[..., None], rows, torch.full_like(rows, -1.0))
    counts = valid.sum(1, dtype=torch.int32)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int32,
                                     device=counts.device),
                         torch.cumsum(counts, 0, dtype=torch.int32)])
    # valid rows come first per image (top_k order); the counts ride the
    # LoD over a PADDED buffer: rows past each count are -1 filler at a
    # fixed stride k
    out_name = ctx.op.outputs["Out"][0]
    ctx.set_lod(out_name, offsets)
    ctx.env[out_name + PAD_STRIDE] = k
    return {"Out": rows.reshape(N * k, 6)}


def _floor_div(a, b):
    return torch.div(a, b, rounding_mode="floor")


@register_op("roi_pool")
def _roi_pool(ctx, ins, attrs):
    """ROI max pooling (reference gserver ROIPoolLayer.cpp, RoIPooling
    per Fast R-CNN): each ROI's window on the feature map is divided into
    a pooled_h x pooled_w grid of bins and each bin max-pooled. Bin
    membership is a pair of separable H/W masks built from aranges and
    the pool a masked max over [R, C, ph, pw, H, W], no per-ROI slicing.
    ROIs: [R, 4] (x1, y1, x2, y2) with a LoD side-band mapping ROIs to
    batch images (offsets [N+1]); without one, every ROI is on image 0.
    """
    x = ins["X"][0]  # [N, C, H, W]
    rois = ins["ROIs"][0].float()  # [R, 4]
    key = lod_key(ctx.op.inputs["ROIs"][0])
    R = rois.shape[0]
    dev = x.device
    batch_of = seg_ids(ctx.env[key], R) if key in ctx.env \
        else torch.zeros(R, dtype=torch.long, device=dev)
    ph = int(attrs["pooled_height"])
    pw = int(attrs["pooled_width"])
    scale = float(attrs.get("spatial_scale", 1.0))
    N, C, H, W = x.shape

    # round to the feature-map grid like the reference (ROIPoolLayer)
    x1, y1, x2, y2 = (torch.round(rois[:, i] * scale).to(torch.int64)
                      for i in range(4))
    rh = torch.clamp_min(y2 - y1 + 1, 1)[:, None]
    rw = torch.clamp_min(x2 - x1 + 1, 1)[:, None]
    # bin p covers [floor(p*rh/ph), ceil((p+1)*rh/ph)) + y1, clipped
    p = torch.arange(ph, device=dev)[None, :]
    hstart = torch.clamp(y1[:, None] + _floor_div(p * rh, ph), 0, H)
    hend = torch.clamp(y1[:, None] - _floor_div(-(p + 1) * rh, ph), 0, H)
    q = torch.arange(pw, device=dev)[None, :]
    wstart = torch.clamp(x1[:, None] + _floor_div(q * rw, pw), 0, W)
    wend = torch.clamp(x1[:, None] - _floor_div(-(q + 1) * rw, pw), 0, W)
    hs = torch.arange(H, device=dev)
    ws = torch.arange(W, device=dev)
    mh = (hs >= hstart[..., None]) & (hs < hend[..., None])  # [R, ph, H]
    mw = (ws >= wstart[..., None]) & (ws < wend[..., None])  # [R, pw, W]
    feat = x.index_select(0, batch_of)  # [R, C, H, W]
    inside = mh[:, None, :, None, :, None] & mw[:, None, None, :, None, :]
    masked = torch.where(inside, feat[:, :, None, None],
                         torch.full((), _NEG, dtype=x.dtype, device=dev))
    pooled = masked.amax(dim=(4, 5))  # [R, C, ph, pw]
    # empty bins read 0 (reference memsets the output)
    pooled = torch.where(pooled <= _NEG, torch.zeros_like(pooled), pooled)
    if key in ctx.env:
        ctx.set_lod(ctx.op.outputs["Out"][0], ctx.env[key])
    return {"Out": pooled}


def _area(b):
    return torch.clamp_min(b[..., 2] - b[..., 0], 0.0) * \
        torch.clamp_min(b[..., 3] - b[..., 1], 0.0)


def _cwh(b):
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return (b[..., 0] + b[..., 2]) / 2, (b[..., 1] + b[..., 3]) / 2, w, h


@register_op("ssd_multibox_loss")
def _ssd_multibox_loss(ctx, ins, attrs):
    """SSD MultiBox training loss (legacy gserver MultiBoxLossLayer.cpp):
    match priors to ground-truth boxes by IoU, smooth-L1 on the encoded
    location offsets of the positives, softmax cross-entropy on class
    confidences with hard negative mining at `neg_pos_ratio`.

    All matching is dense over a [N, P, G] IoU tensor (G = packed
    ground-truth boxes across the batch, images told apart by the LoD
    side-band); the bipartite guarantee is G rounds of a global argmax.
    Emits a per-image cost [N, 1], each image normalised by its matched
    prior count (the reference normalises by the batch's total)."""
    loc = ins["Loc"][0]  # [N, P, 4] predicted offsets
    conf = ins["Conf"][0]  # [N, P, C] raw logits
    gt_box = ins["GTBox"][0]  # [G, 4] corners, packed over the batch
    gt_label = ins["GTLabel"][0].reshape(-1).long()  # [G]
    priors = ins["PriorBox"][0]  # [P, 4] corners
    prior_var = ins["PriorVar"][0]  # [P, 4]
    offsets = ctx.env[lod_key(ctx.op.inputs["GTBox"][0])]  # [N+1]
    N, P, C = conf.shape
    G = gt_box.shape[0]
    dev = conf.device
    overlap_t = float(attrs.get("overlap_threshold", 0.5))
    neg_overlap = float(attrs.get("neg_overlap", 0.5))
    neg_ratio = float(attrs.get("neg_pos_ratio", 3.0))
    bg = int(attrs.get("background_id", 0))

    img_of = seg_ids(offsets, G)  # [G]
    lt = torch.maximum(priors[:, None, :2], gt_box[None, :, :2])
    rb = torch.minimum(priors[:, None, 2:], gt_box[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]  # [P, G]
    union = _area(priors)[:, None] + _area(gt_box)[None, :] - inter
    iou = inter / torch.clamp_min(union, 1e-10)

    in_img = img_of[None, :] == torch.arange(N, device=dev)[:, None]
    iou_n = torch.where(in_img[:, None, :], iou[None, :, :],
                        torch.full((), -1.0, device=dev))  # [N, P, G]
    best_iou, best_g = iou_n.max(dim=2)  # [N, P]: the first maximum
    pos = best_iou > overlap_t

    # bipartite guarantee: greedy global matching, one (gt, prior) pair
    # per round with already-claimed priors and gts masked out, so each
    # gt gets a DISTINCT prior even when two share a best prior
    claimed = torch.zeros(N * P, dtype=torch.bool, device=dev)
    best_g = best_g.reshape(N * P)
    matched = torch.zeros(G, dtype=torch.bool, device=dev)
    minus = torch.full((), -1.0, device=dev)
    for _ in range(G):
        sc = torch.where(matched[None, :], minus, iou)
        sc = torch.where(claimed.reshape(N, P).index_select(0, img_of).T,
                         minus, sc)
        idx = torch.argmax(sc).reshape(1)
        p_star, g_star = idx // G, idx % G
        ok = sc.reshape(-1).index_select(0, idx) > 0.0
        slot = _at(img_of, g_star) * P + p_star
        claimed = claimed.scatter(0, slot, _at(claimed, slot) | ok)
        best_g = best_g.scatter(0, slot, torch.where(ok, g_star,
                                                     _at(best_g, slot)))
        matched = matched.scatter(0, g_star, _at(matched, g_star) | ok)
    best_g = best_g.reshape(N, P)
    has_gt = (offsets[1:] - offsets[:-1]) > 0
    pos = (pos | claimed.reshape(N, P)) & has_gt[:, None]

    # location loss: smooth L1 on the encoded offsets, positives only
    pcx, pcy, pw, ph = _cwh(priors)
    gcx, gcy, gw, gh = _cwh(gt_box[best_g])  # [N, P]
    var = prior_var[None]  # [1, P, 4]
    pw_, ph_ = torch.clamp_min(pw, 1e-10), torch.clamp_min(ph, 1e-10)
    tgt = torch.stack([
        (gcx - pcx) / pw_ / var[..., 0],
        (gcy - pcy) / ph_ / var[..., 1],
        torch.log(torch.clamp_min(gw / pw_, 1e-10)) / var[..., 2],
        torch.log(torch.clamp_min(gh / ph_, 1e-10)) / var[..., 3],
    ], dim=-1)  # [N, P, 4]
    d = loc - tgt.detach()
    sl1 = torch.where(torch.abs(d) < 1.0, 0.5 * d * d, torch.abs(d) - 0.5)
    zero = torch.zeros((), dtype=conf.dtype, device=dev)
    loc_loss = torch.where(pos, sl1.sum(-1), zero).sum(1)  # [N]

    # confidence loss with hard negative mining
    tgt_label = torch.where(pos, gt_label[best_g],
                            torch.full_like(best_g, bg))
    logp = torch.log_softmax(conf, dim=-1)
    ce = -torch.gather(logp, -1, tgt_label[..., None])[..., 0]  # [N, P]
    n_pos = pos.sum(1)
    n_neg = torch.minimum((neg_ratio * n_pos.float()).to(torch.int64),
                          P - n_pos)
    neg_cand = ~pos & (best_iou < neg_overlap)
    neg_score = torch.where(neg_cand, ce.detach(),
                            torch.full((), -math.inf, device=dev))
    # per image, hardest first: a stable sort, then each prior's rank in
    # it (the inverse permutation: the JAX package's second argsort)
    order = torch.argsort(-neg_score, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(P, device=dev).expand(N, P).contiguous())
    neg = neg_cand & (rank < n_neg[:, None])
    conf_loss = torch.where(pos | neg, ce, zero).sum(1)  # [N]
    denom = torch.clamp_min(n_pos.to(conf.dtype), 1.0)
    return {"Out": ((loc_loss + conf_loss) / denom)[:, None]}


@register_op("detection_map")
def _detection_map(ctx, ins, attrs):
    """Per-batch VOC mean Average Precision as a GRAPH metric (reference
    gserver/evaluators/DetectionMAPEvaluator.cpp; the host-side
    accumulating form is evaluator.DetectionMAP).

    Inputs: Detection = the padded multiclass_nms buffer [N*K, 6]
    (rows [label, score, x1, y1, x2, y2], -1 padded, pad stride K from
    the producing op's @PAD_STRIDE side-band or the pad_stride attr);
    GTBox [G, 4] packed with an image LoD; GTLabel [G, 1]; optional
    GTDifficult [G, 1] (difficult ground truth is excluded from recall
    counts and its matches score neither TP nor FP, per VOC). Matching
    follows the VOC protocol: in score order each detection takes its
    best-OVERLAP ground truth; if that box is already claimed the
    detection is a false positive. With every class's detections in
    score order, a detection claims its box exactly when no earlier one
    of its class that could claim (live, over the threshold, not
    difficult) picked the same box: a cumulative count over that order
    replaces the JAX package's row-by-row loop. AP is the integral form.
    """
    det = ins["Detection"][0]  # [M, 6]
    gt_box = ins["GTBox"][0]  # [G, 4]
    gt_label = ins["GTLabel"][0].reshape(-1).long()
    G = gt_box.shape[0]
    dev = det.device
    difficult = ins["GTDifficult"][0].reshape(-1).to(torch.bool) \
        if ins.get("GTDifficult") \
        else torch.zeros(G, dtype=torch.bool, device=dev)
    det_name = ctx.op.inputs["Detection"][0]
    offsets = ctx.env[lod_key(ctx.op.inputs["GTBox"][0])]
    if attrs.get("pad_stride"):
        K = int(attrs["pad_stride"])  # direct/test feeds
    elif det_name + PAD_STRIDE in ctx.env:
        K = int(ctx.env[det_name + PAD_STRIDE])
    else:
        raise ValueError(
            "detection_map input %r has no @PAD_STRIDE side-band: feed "
            "it the multiclass_nms/detection_output buffer directly, or "
            "set the pad_stride attr explicitly" % det_name)
    M = det.shape[0]
    C = int(attrs.get("num_classes", 0))
    if not C:
        raise ValueError("detection_map needs a num_classes attr")
    thresh = float(attrs.get("overlap_threshold", 0.5))
    bg = int(attrs.get("background_id", -1))

    det_img = torch.arange(M, device=dev) // K  # [M]
    gt_img = seg_ids(offsets, G)  # [G]
    valid = det[:, 0] >= 0
    lt = torch.maximum(det[:, None, 2:4], gt_box[None, :, :2])
    rb = torch.minimum(det[:, None, 4:6], gt_box[None, :, 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]  # [M, G]
    area_d = torch.clamp_min(det[:, 4] - det[:, 2], 0.0) * \
        torch.clamp_min(det[:, 5] - det[:, 3], 0.0)
    iou = inter / torch.clamp_min(area_d[:, None] + _area(gt_box)[None, :]
                                  - inter, 1e-12)
    same_img = det_img[:, None] == gt_img[None, :]

    classes = torch.arange(C, device=dev)
    gt_of = gt_label[None, :] == classes[:, None]  # [C, G]
    is_c = valid[None, :] & (det[None, :, 0].to(torch.int64)
                             == classes[:, None])  # [C, M]
    n_gt = (gt_of & ~difficult[None, :]).sum(1)  # [C]
    scores = torch.where(is_c, det[None, :, 1],
                         torch.full((), -math.inf, device=dev))  # [C, M]
    order = torch.argsort(-scores, dim=1, stable=True)  # [C, M]
    cand = torch.where(same_img[None] & gt_of[:, None, :], iou[None],
                       torch.zeros((), device=dev))  # [C, M, G]
    # everything in each class's score order
    live = torch.isfinite(torch.gather(scores, 1, order))  # [C, M]
    rows = torch.gather(cand, 1, order[..., None].expand(C, M, G))
    best_iou, best = rows.max(dim=2)  # [C, M]: the first maximum
    overlap = best_iou > thresh
    hard = difficult[best]
    claims = live & overlap & ~hard
    picks = claims[..., None] & (best[..., None]
                                 == torch.arange(G, device=dev))
    earlier = torch.cumsum(picks.to(torch.int32), 1) - picks.to(torch.int32)
    fresh = torch.gather(earlier, 2, best[..., None])[..., 0] == 0
    is_tp = claims & fresh
    # difficult matches: neither TP nor FP (VOC); claimed-gt or
    # low-overlap detections are FPs
    is_fp = live & ~(overlap & hard) & ~is_tp
    tp, fp = is_tp.float(), is_fp.float()
    ctp = torch.cumsum(tp, 1)
    cfp = torch.cumsum(fp, 1)
    precision = ctp / torch.clamp_min(ctp + cfp, 1e-12)
    recall_step = tp / torch.clamp_min(n_gt[:, None].float(), 1.0)
    aps = (precision * recall_step).sum(1)  # [C]
    has_gt = (n_gt > 0) & (classes != bg)
    mAP = (aps * has_gt).sum() / torch.clamp_min(has_gt.float().sum(), 1.0)
    return {"MAP": mAP.reshape(1)}


@register_op("pnpair_eval")
def _pnpair_eval(ctx, ins, attrs):
    """Positive-negative pair ratio (reference gserver
    PnpairEvaluator): over all within-query pairs with different labels,
    the fraction ranked correctly by score (ties count half)."""
    score = ins["Score"][0].reshape(-1)
    label = ins["Label"][0].reshape(-1).float()
    query = ins["QueryID"][0].reshape(-1)
    w = ins["Weight"][0].reshape(-1).float() if ins.get("Weight") \
        else torch.ones_like(score)
    same_q = query[:, None] == query[None, :]
    pos_pair = same_q & (label[:, None] > label[None, :])
    pair_w = w[:, None] * w[None, :]
    correct = (score[:, None] > score[None, :]).float()
    tie = (score[:, None] == score[None, :]).float()
    zero = torch.zeros((), device=score.device)
    num = torch.where(pos_pair, (correct + 0.5 * tie) * pair_w, zero).sum()
    den = torch.clamp_min(torch.where(pos_pair, pair_w, zero).sum(), 1e-12)
    return {"Out": (num / den).reshape(1)}
