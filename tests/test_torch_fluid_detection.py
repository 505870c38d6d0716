"""The eight detection op kernels of the port (prior_box, box_coder,
bipartite_match, multiclass_nms, roi_pool, ssd_multibox_loss,
detection_map, pnpair_eval) against the JAX package's on the same
seeded inputs, on the CPU; the cases follow tests/test_detection_ops.py.

Tolerances: integer outputs exactly equal (match indices, NMS labels and
row order, per-image counts); float outputs within atol/rtol 1e-5 (box
arithmetic, IoUs and log-softmax of O(1) values, reduction order only),
gradients too; the mAP within 1e-6."""

import numpy as np
import pytest
import torch

from test_torch_fluid_lrn_zoo import vjp_both
from test_torch_fluid_ops import _op, assert_same, run_both
from paddle_tpu_torch.fluid.core.registry import LoweringContext as TCtx
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel

torch.set_num_threads(2)


def offsets(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


def random_boxes(rng, n, lo=0.05, hi=0.3):
    centers = rng.rand(n, 2).astype(np.float32)
    sizes = lo + (hi - lo) * rng.rand(n, 2).astype(np.float32)
    return np.concatenate([centers - sizes / 2, centers + sizes / 2],
                          axis=1).astype(np.float32)


PRIOR_BOX = {
    "min_max_flip_clip": dict(min_sizes=[8.0], max_sizes=[16.0],
                              aspect_ratios=[2.0], flip=True, clip=True),
    "two_min_sizes_steps": dict(min_sizes=[4.0, 10.0], max_sizes=[],
                                aspect_ratios=[2.0, 3.0], flip=False,
                                clip=False, step_w=6.0, step_h=5.0,
                                offset=0.25,
                                variances=[0.1, 0.2, 0.3, 0.4]),
}


@pytest.mark.parametrize("case", sorted(PRIOR_BOX))
def test_prior_box(case):
    rng = np.random.RandomState(0)
    j, t, _ = run_both("prior_box",
                       {"Input": [rng.rand(1, 8, 4, 5).astype(np.float32)],
                        "Image": [rng.rand(1, 3, 32, 40).astype(np.float32)]},
                       PRIOR_BOX[case])
    assert_same(j, t)


@pytest.mark.parametrize("with_var", [True, False])
@pytest.mark.parametrize("code", ["encode_center_size",
                                  "decode_center_size"])
def test_box_coder(code, with_var):
    rng = np.random.RandomState(1)
    M = 12
    ins = {"PriorBox": [random_boxes(rng, M)],
           "TargetBox": [random_boxes(rng, M) if code.startswith("encode")
                         else rng.randn(3, M, 4).astype(np.float32) * 0.5]}
    if with_var:
        ins["PriorBoxVar"] = [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                      (M, 1))]
    j, t, _ = run_both("box_coder", ins, dict(code_type=code))
    assert_same(j, t)


BIPARTITE = {
    "greedy_3x3": np.array([[0.1, 0.9, 0.3], [0.8, 0.2, 0.7],
                            [0.4, 0.5, 0.6]], np.float32),
    "wide_5x7": np.random.RandomState(2).rand(5, 7).astype(np.float32),
    "tall_7x5": np.random.RandomState(3).rand(7, 5).astype(np.float32),
    # exact ties: the first maximum in row-major order wins each round
    "ties": np.array([[0.5, 0.5, 0.2], [0.5, 0.5, 0.2],
                      [0.2, 0.2, 0.2]], np.float32),
}


@pytest.mark.parametrize("case", sorted(BIPARTITE))
def test_bipartite_match(case):
    j, t, _ = run_both("bipartite_match", {"DistMat": [BIPARTITE[case]]},
                       {})
    np.testing.assert_array_equal(t["ColToRowMatchIndices"][0],
                                  j["ColToRowMatchIndices"][0])
    assert_same(j, t, slots=["ColToRowMatchDist"])
    if case == "greedy_3x3":
        assert t["ColToRowMatchIndices"][0].tolist() == [[1, 0, 2]]


def test_bipartite_match_refuses_ragged_batches():
    dist = np.random.RandomState(4).rand(4, 3).astype(np.float32)
    lods = {"DistMat": offsets([2, 2])}
    with pytest.raises(NotImplementedError, match="ragged"):
        run_both("bipartite_match", {"DistMat": [dist]}, {}, lods=lods)
    op = _op({"DistMat": [dist]})
    op.type = "bipartite_match"
    ctx = TCtx(None, None, "cpu")
    ctx.op = op
    ctx.env = {"DistMat@LOD0": torch.from_numpy(lods["DistMat"])}
    with pytest.raises(NotImplementedError, match="ragged"):
        tkernel("bipartite_match")(
            ctx, {"DistMat": [torch.from_numpy(dist)]}, {})


def nms_inputs(seed, N=2, C=3, M=10, tie=False):
    rng = np.random.RandomState(seed)
    boxes = random_boxes(rng, M, 0.1, 0.3)
    scores = rng.rand(N, C, M).astype(np.float32)
    if tie:  # equal scores: the lower index first, as lax.top_k
        scores = np.round(scores * 4) / 4
    return {"Scores": [scores],
            "BBoxes": [np.stack([boxes + 0.01 * n for n in range(N)])
                       .astype(np.float32)]}


NMS = {
    "test_detection_ops": (nms_inputs(1), dict(
        background_label=0, nms_threshold=0.4, keep_top_k=20,
        score_threshold=0.01)),
    "nms_top_k_caps": (nms_inputs(5, N=3, C=4, M=16), dict(
        background_label=0, nms_threshold=0.3, nms_top_k=5, keep_top_k=6,
        score_threshold=0.2)),
    "no_background_all_kept": (nms_inputs(6, C=2, M=8), dict(
        background_label=-1, nms_threshold=0.5, keep_top_k=-1,
        score_threshold=0.0)),
    "tied_scores": (nms_inputs(7, M=12, tie=True), dict(
        background_label=0, nms_threshold=0.45, keep_top_k=10,
        score_threshold=0.1)),
}


@pytest.mark.parametrize("case", sorted(NMS))
def test_multiclass_nms(case):
    ins, attrs = NMS[case]
    j, t, _ = run_both("multiclass_nms", ins, attrs, outs=("Out",))
    jo, to = j["Out"][0], t["Out"][0]
    assert to.shape == jo.shape
    np.testing.assert_array_equal(to[:, 0], jo[:, 0])  # labels, row order
    np.testing.assert_allclose(to, jo, atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(t["Out@LOD0"][0], j["Out@LOD0"][0])
    assert t["Out@LOD0"][0][-1] > 0


def test_roi_pool_forward_and_gradient():
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 12, 10).astype(np.float32)
    rois = np.array([[0, 0, 11, 9], [2, 3, 7, 8], [5, 5, 5, 5],
                     [1, 0, 19, 23], [4, 2, 9, 3]], np.float32)
    ins = {"X": [x], "ROIs": [rois]}
    attrs = dict(pooled_height=2, pooled_width=3, spatial_scale=0.5)
    lods = {"ROIs": offsets([2, 3])}
    j, t, _ = run_both("roi_pool", ins, attrs, lods=lods, outs=("Out",))
    assert_same(j, t)
    np.testing.assert_array_equal(t["Out@LOD0"][0], j["Out@LOD0"][0])
    jy, ty, jg, tg = vjp_both("roi_pool", ins, attrs, ["X"], "Out",
                              lods=lods)
    np.testing.assert_allclose(tg[0], jg[0], atol=1e-5, rtol=1e-5)


def ssd_loss_inputs(seed, gts=(2, 0, 3), P=40, C=4):
    rng = np.random.RandomState(seed)
    N = len(gts)
    G = sum(gts)
    return {"Loc": [rng.randn(N, P, 4).astype(np.float32) * 0.5],
            "Conf": [rng.randn(N, P, C).astype(np.float32)],
            "GTBox": [random_boxes(rng, G, 0.2, 0.5)],
            "GTLabel": [rng.randint(1, C, (G, 1)).astype(np.int64)],
            "PriorBox": [random_boxes(rng, P, 0.1, 0.5)],
            "PriorVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                 (P, 1))]}, {"GTBox": offsets(gts)}


@pytest.mark.parametrize("gts", [(2, 0, 3), (1, 1, 1, 1), (4,)])
def test_ssd_multibox_loss_and_gradients(gts):
    ins, lods = ssd_loss_inputs(9, gts)
    attrs = dict(overlap_threshold=0.5, neg_pos_ratio=3.0, neg_overlap=0.5,
                 background_id=0)
    j, t, _ = run_both("ssd_multibox_loss", ins, attrs, lods=lods)
    assert_same(j, t)
    jy, ty, jg, tg = vjp_both("ssd_multibox_loss", ins, attrs,
                              ["Loc", "Conf"], "Out", lods=lods)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


def _det_rows(rng, n_img, K, C, gt, gt_lod, hits):
    """[n_img * K, 6] -1-padded rows: some copies of ground-truth boxes
    (true positives and duplicates), some random boxes and labels."""
    rows = np.full((n_img * K, 6), -1.0, np.float32)
    for n in range(n_img):
        own = list(range(gt_lod[n], gt_lod[n + 1]))
        for k in range(hits[n]):
            if own and k < 2 * len(own):
                g = own[k % len(own)]
                box = gt[g, :4] + 0.02 * rng.randn(4)
                label = gt[g, 4]
            else:
                box = random_boxes(rng, 1)[0]
                label = rng.randint(0, C)
            rows[n * K + k] = [label, rng.rand(), *box]
    return rows


def test_detection_map():
    """The VOC cases of tests/test_detection_ops.py (a claimed best
    overlap is a false positive; difficult ground truth neither helps nor
    hurts) and a seeded batch of three images, four classes."""
    def both(det, K, gt, lod, C, difficult=None, bg=-1):
        ins = {"Detection": [det], "GTBox": [gt[:, :4].copy()],
               "GTLabel": [gt[:, 4:5].astype(np.int64)]}
        if difficult is not None:
            ins["GTDifficult"] = [difficult]
        j, t, _ = run_both("detection_map", ins, dict(
            overlap_threshold=0.5, num_classes=C, pad_stride=K,
            background_id=bg), lods={"GTBox": lod})
        np.testing.assert_allclose(t["MAP"][0], j["MAP"][0], atol=1e-6)
        return float(t["MAP"][0][0])

    gt = np.array([[0.1, 0.1, 0.5, 0.5, 1]], np.float32)
    det = np.array([[1, 0.9, 0.1, 0.1, 0.5, 0.5], [-1] * 6], np.float32)
    assert both(det, 2, gt, offsets([1]), 2) == pytest.approx(1.0)
    gt2 = np.array([[0.0, 0.0, 1.0, 1.0, 1], [0.0, 0.0, 0.8, 0.8, 1]],
                   np.float32)
    det2 = np.array([[1, 0.95, 0.0, 0.0, 1.0, 1.0],
                     [1, 0.80, 0.0, 0.0, 0.95, 0.95]], np.float32)
    assert both(det2, 2, gt2, offsets([2]), 2) == pytest.approx(0.5)
    gt3 = np.array([[0.1, 0.1, 0.5, 0.5, 1], [0.6, 0.6, 0.9, 0.9, 1]],
                   np.float32)
    det3 = np.array([[1, 0.9, 0.1, 0.1, 0.5, 0.5],
                     [1, 0.8, 0.6, 0.6, 0.9, 0.9]], np.float32)
    assert both(det3, 2, gt3, offsets([2]), 2,
                difficult=np.array([[0.0], [1.0]], np.float32)) == \
        pytest.approx(1.0)

    rng = np.random.RandomState(10)
    lens, C, K = [3, 1, 2], 4, 6
    lod = offsets(lens)
    gt = np.concatenate([random_boxes(rng, sum(lens), 0.2, 0.4),
                         rng.randint(1, C, (sum(lens), 1))], 1).astype(
        np.float32)
    det = _det_rows(rng, 3, K, C, gt, lod, hits=[6, 3, 4])
    diff = (rng.rand(sum(lens), 1) < 0.3).astype(np.float32)
    m = both(det, K, gt, lod, C, difficult=diff, bg=0)
    assert 0.0 < m <= 1.0


@pytest.mark.parametrize("weighted", [False, True])
def test_pnpair_eval(weighted):
    rng = np.random.RandomState(11)
    n = 30
    ins = {"Score": [np.round(rng.rand(n, 1) * 5).astype(np.float32)],
           "Label": [rng.randint(0, 3, (n, 1)).astype(np.float32)],
           "QueryID": [rng.randint(0, 4, (n, 1)).astype(np.int64)]}
    if weighted:
        ins["Weight"] = [rng.rand(n, 1).astype(np.float32)]
    j, t, _ = run_both("pnpair_eval", ins, {})
    assert_same(j, t, atol=1e-6, rtol=1e-6)
