"""The ported CTC kernels (kernels_ctc.py: warpctc and its WarpCTCGrad,
edit_distance, ctc_align) against the JAX package's on the same numpy
inputs and offsets (from a seed), through each package's registry
(`run_both`) and, for the loss and WarpCTCGrad of a program, through
each package's executor (`FluidPair`).

Tolerances: losses and gradients within atol/rtol 1e-5 (f32 log-space
sums in different orders); distances, decoded tokens and output offsets
exact."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_fluid_ops import run_both

torch.set_num_threads(2)

R = np.random.RandomState(12)
C = 6
T_OFF = np.asarray([0, 5, 6, 13, 20], np.int32)   # frames 5, 1, 7, 7
L_OFF = np.asarray([0, 2, 3, 6, 6], np.int32)     # labels 2, 1, 3, 0


def assert_same(j, t, slots, atol=1e-5):
    for slot in slots:
        for a, b in zip(j[slot], t[slot]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(b, a, err_msg=slot)
            else:
                np.testing.assert_allclose(b, a, atol=atol, rtol=1e-5,
                                           err_msg=slot)


CTC = {
    "blank0": dict(blank=0),
    "blank_last_norm_by_times": dict(blank=C - 1, norm_by_times=True),
}


@pytest.mark.parametrize("case", sorted(CTC))
def test_warpctc_loss_and_grad(case):
    attrs = CTC[case]
    blank = attrs["blank"]
    # ids 0..C-1 without the blank
    labels = (R.randint(0, C - 1, (int(L_OFF[-1]), 1))
              + (1 if blank == 0 else 0)).astype(np.int64)
    labels[1] = labels[0]  # a repeated label: no skip transition there
    logits = R.randn(int(T_OFF[-1]), C).astype(np.float32)
    j, t, _ = run_both("warpctc", {"Logits": [logits], "Label": [labels]},
                       attrs, lods={"Logits": T_OFF, "Label": L_OFF},
                       outs=["Loss", "WarpCTCGrad"], keep=["WarpCTCGrad"])
    assert_same(j, t, ["Loss", "WarpCTCGrad"])
    assert np.isfinite(t["Loss"][0]).all()


def test_warpctc_grad_is_skipped_when_nothing_reads_it():
    logits = R.randn(int(T_OFF[-1]), C).astype(np.float32)
    labels = R.randint(1, C, (int(L_OFF[-1]), 1)).astype(np.int64)
    j, t, _ = run_both("warpctc", {"Logits": [logits], "Label": [labels]},
                       {}, lods={"Logits": T_OFF, "Label": L_OFF},
                       outs=["Loss", "WarpCTCGrad"])
    assert "WarpCTCGrad" not in t
    assert_same(j, t, ["Loss"])


def test_warpctc_through_the_executor():
    """The loss trains through autograd and the fetched WarpCTCGrad is
    the JAX package's."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32",
                              lod_level=1)
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        logits = fluid.layers.fc(input=x, size=C)
        loss = fluid.layers.mean(
            x=fluid.layers.warpctc(input=logits, label=lab, blank=0))
        grad = [op for op in fluid.default_main_program().global_block().ops
                if op.type == "warpctc"][0].output("WarpCTCGrad")[0]
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss, ctc_grad=grad)

    pair = tp.FluidPair(build)
    feed = {"x": (R.randn(int(T_OFF[-1]), 3).astype(np.float32), [T_OFF]),
            "lab": (R.randint(1, C, (int(L_OFF[-1]), 1)).astype(np.int64),
                    [L_OFF])}
    for _ in range(2):
        j, t = pair.run(feed, ["loss", "ctc_grad"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        np.testing.assert_allclose(t[1], j[1], atol=1e-5, rtol=1e-5)
    assert max(pair.state_diff()[n]
               for n in pair.model_state_names()) <= 1e-5


@pytest.mark.parametrize("normalized", [False, True])
def test_edit_distance(normalized):
    h_off = np.asarray([0, 3, 3, 8, 9], np.int32)   # an empty hypothesis
    r_off = np.asarray([0, 4, 6, 9, 10], np.int32)
    hyp = R.randint(0, 4, (9, 1)).astype(np.int64)
    ref = R.randint(0, 4, (10, 1)).astype(np.int64)
    j, t, _ = run_both("edit_distance", {"Hyps": [hyp], "Refs": [ref]},
                       dict(normalized=normalized),
                       lods={"Hyps": h_off, "Refs": r_off})
    assert_same(j, t, ["Out", "SequenceNum"])


@pytest.mark.parametrize("width", [C, 1], ids=["probs", "ids"])
def test_ctc_align(width):
    if width == 1:
        x = R.randint(0, 3, (int(T_OFF[-1]), 1)).astype(np.int32)
    else:
        x = R.rand(int(T_OFF[-1]), C).astype(np.float32)
    j, t, _ = run_both("ctc_align", {"Input": [x]}, dict(blank=0),
                       lods={"Input": T_OFF}, outs=["Output"])
    assert_same(j, t, ["Output", "Output@LOD0"])
