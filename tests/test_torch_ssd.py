"""The SSD detector (models/ssd.py: ssd_lite's backbone and heads,
prior_box, ssd_loss, detection_output) through the port's Executor
against the JAX package's, at tests/test_ssd_model.py's shapes (S 32,
batch 4, 3 classes) on its synthetic single-object images.

Tolerances: losses within rtol 1e-4 over 3 Adam(2e-3) steps from the
same JAX startup weights; the detections of every step row for row:
labels and per-image order equal, scores and boxes within atol 1e-4
(Adam turns reduction-order differences in near-zero gradients into
parameter differences of up to ~lr); the host DetectionMAP of the last
step's detections equal to 1e-6."""

import numpy as np
import torch

import torch_parity as tp
from test_ssd_model import C, N, S, _batch
from paddle_tpu.fluid.evaluator import DetectionMAP as JMAP
from paddle_tpu.models import ssd as JS
from paddle_tpu_torch.fluid.evaluator import DetectionMAP as TMAP
from paddle_tpu_torch.models import ssd as TS

torch.set_num_threads(2)


def build(fluid, resnet):
    image = fluid.layers.data(name="image", shape=[3, S, S], dtype="float32")
    gt_box = fluid.layers.data(name="gt_box", shape=[4], dtype="float32",
                               lod_level=1)
    gt_label = fluid.layers.data(name="gt_label", shape=[1], dtype="int64",
                                 lod_level=1)
    ssd = JS if fluid is tp.JF else TS
    avg_cost, detections = ssd.ssd_detector(
        image, gt_box, gt_label, num_classes=C, image_size=S, batch=N)
    fluid.optimizer.Adam(learning_rate=2e-3).minimize(avg_cost)
    return dict(loss=avg_cost, dets=detections)


def per_image(dets, gbox, glab, evaluator):
    stride = dets.shape[0] // N
    rows = [dets[n * stride:(n + 1) * stride] for n in range(N)]
    ev = evaluator(overlap_threshold=0.3)
    ev.update([r[r[:, 0] >= 0] for r in rows],
              [gbox[n:n + 1] for n in range(N)],
              [glab[n:n + 1, 0] for n in range(N)])
    return ev.eval()


def test_ssd_trains_and_detects_like_the_jax_executor():
    pair = tp.FluidPair(build)
    rng = np.random.RandomState(0)
    for _ in range(3):
        img, gb, gl = _batch(rng)
        feed = {"image": img, "gt_box": gb, "gt_label": gl}
        (jl, jd), (tl, td) = pair.run(feed, ["loss", "dets"])
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        assert td.shape == jd.shape == (N * 8, 6)
        np.testing.assert_array_equal(td[:, 0], jd[:, 0])
        np.testing.assert_allclose(td, jd, atol=1e-4)
    valid = td[td[:, 0] >= 0]
    assert len(valid) > 0
    assert ((valid[:, 1] >= 0) & (valid[:, 1] <= 1)).all()
    gbox, glab = gb[0], gl[0]
    np.testing.assert_allclose(per_image(td, gbox, glab, TMAP),
                               per_image(jd, gbox, glab, JMAP), atol=1e-6)


def test_ssd_lite_static_shapes():
    """tests/test_ssd_model.py::test_ssd_lite_static_shapes on the port:
    stride-4 map 8x8x3 priors, stride-8 map 4x4x3, 240 in all, as
    normalized corner boxes; the same values as the JAX package's."""
    def lite(fluid, resnet):
        image = fluid.layers.data(name="image", shape=[3, S, S],
                                  dtype="float32")
        ssd = JS if fluid is tp.JF else TS
        loc, conf, pb, pbv = ssd.ssd_lite(image, num_classes=C,
                                          image_size=S, batch=N)
        return dict(loc=loc, conf=conf, pb=pb, pbv=pbv)

    pair = tp.FluidPair(lite)
    feed = {"image": np.random.RandomState(1).rand(N, 3, S, S).astype(
        np.float32)}
    j, t = pair.run(feed, ["loc", "conf", "pb", "pbv"])
    P = 8 * 8 * 3 + 4 * 4 * 3
    lo, co, p, pv = t
    assert lo.shape == (N, P, 4)
    assert co.shape == (N, P, C)
    assert p.shape == (P, 4) and pv.shape == (P, 4)
    assert (p >= 0).all() and (p <= 1).all()
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)


def test_detection_map_after_minimize_reads_the_nms_pad_stride():
    """A detection_map op built after minimize (as an evaluator is) runs
    in the tail region and still finds the forward region's NMS buffer
    and its pad stride; the training step's mAP equals the JAX
    package's."""
    def with_map(fluid, resnet):
        out = build(fluid, resnet)
        block = fluid.default_main_program().global_block()
        gt_box, gt_label = block.var("gt_box"), block.var("gt_label")
        helper = fluid.layer_helper.LayerHelper("detection_map")
        m = helper.create_tmp_variable(dtype="float32")
        helper.append_op(
            type="detection_map",
            inputs={"Detection": [out["dets"]], "GTBox": [gt_box],
                    "GTLabel": [gt_label]},
            outputs={"MAP": [m]},
            attrs={"overlap_threshold": 0.3, "num_classes": C,
                   "background_id": 0})
        return dict(out, map=m)

    pair = tp.FluidPair(with_map)
    rng = np.random.RandomState(2)
    for _ in range(2):
        img, gb, gl = _batch(rng)
        (jl, jm), (tl, tm) = pair.run(
            {"image": img, "gt_box": gb, "gt_label": gl}, ["loss", "map"])
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
        np.testing.assert_allclose(tm, jm, atol=1e-6)
