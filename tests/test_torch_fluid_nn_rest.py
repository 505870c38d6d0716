"""The last Fluid op kernels of the port (the 3-D and transposed
convolutions, pool3d, the `_with_index` pools, unpool, spp, norm,
bilinear_tensor_product, modified_huber_loss, soft_relu,
gaussian_random_noise and average_accumulates) against the JAX
package's kernels on the same seeded numpy inputs, on the CPU, at the
cases of tests/test_op_numeric.py plus the padding, ceil-mode and
dropped-index corners.

Tolerances: f32 outputs and the gradients through jax.vjp and
torch.autograd (one seeded cotangent) within rtol 1e-5 / atol 1e-5
(reduction order only; the convolutions 1e-4, as tests/
test_torch_fluid_ops.py holds conv2d); integer outputs (the pool masks,
the averaging counters) and the gaussian noise equal."""

import numpy as np
import pytest
import torch

from test_op_numeric import SPECS
from test_torch_fluid_lrn_zoo import vjp_both
from test_torch_fluid_ops import assert_same, run_both
from paddle_tpu.fluid.core.registry import registered_ops as jops
from paddle_tpu_torch.fluid.core.registry import registered_ops as tops

torch.set_num_threads(2)

# the cases of tests/test_op_numeric.py for the ops this file covers
CASES = ["conv2d_transpose", "conv2d_transpose_s2", "conv3d",
         "conv3d_s2p1", "conv3d_transpose", "pool3d",
         "max_pool2d_with_index", "max_pool3d_with_index", "unpool",
         "spp_max", "spp_avg", "norm", "bilinear_tensor_product",
         "modified_huber_loss", "soft_relu"]
CONVS = ("conv2d_transpose", "conv3d")


def _tol(op):
    return 1e-4 if op.startswith(CONVS) else 1e-5


def _grad_slots(spec):
    g = spec.get("grad")
    if g is True:
        return [k for k, v in spec["ins"].items()
                if np.asarray(v).dtype.kind == "f"]
    return list(g or [])


def check_case(op, ins, attrs, out_slot, wrt):
    """Forward outputs (all slots, integers equal) and the gradients of
    `out_slot` with respect to `wrt`, JAX vs port."""
    tol = _tol(op)
    j, t, _ = run_both(op, {k: [v] for k, v in ins.items()}, attrs)
    for slot in j:
        a, b = np.asarray(j[slot][0]), t[slot][0]
        assert a.shape == b.shape, (slot, a.shape, b.shape)
        if a.dtype.kind in "iu":
            assert b.dtype.kind in "iu", slot
            np.testing.assert_array_equal(b, a, err_msg=slot)
        else:
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol,
                                       err_msg=slot)
    if wrt:
        jy, ty, jg, tg = vjp_both(op, {k: [v] for k, v in ins.items()},
                                  attrs, wrt, out_slot)
        np.testing.assert_allclose(ty, jy, rtol=tol, atol=tol)
        for k, a, b in zip(wrt, jg, tg):
            np.testing.assert_allclose(b, a, rtol=tol, atol=tol, err_msg=k)


@pytest.mark.parametrize("name", CASES)
def test_op_numeric_case(name):
    spec = SPECS[name]
    op = spec.get("op", name)
    out_slot = (spec.get("loss") or spec.get("outs") or ["Out"])[0]
    check_case(op, spec["ins"], spec.get("attrs", {}), out_slot,
               _grad_slots(spec))


R = np.random.RandomState(7)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


POOL3D = {
    "max_k3_s2_p1": dict(pooling_type="max", ksize=[3, 3, 3],
                         strides=[2, 2, 2], paddings=[1, 1, 1]),
    "max_ceil": dict(pooling_type="max", ksize=[2, 2, 2],
                     strides=[2, 2, 2], ceil_mode=True),
    "avg_exclusive_p1": dict(pooling_type="avg", ksize=[3, 3, 3],
                             strides=[2, 2, 2], paddings=[1, 1, 1]),
    "avg_inclusive_ceil": dict(pooling_type="avg", ksize=[2, 2, 2],
                               strides=[2, 2, 2], ceil_mode=True,
                               exclusive=False),
    "avg_exclusive_pad_over_half": dict(pooling_type="avg",
                                        ksize=[2, 3, 3], strides=[1, 2, 2],
                                        paddings=[1, 2, 2]),
    "max_global": dict(pooling_type="max", ksize=[1, 1, 1],
                       global_pooling=True),
}


@pytest.mark.parametrize("case", sorted(POOL3D))
def test_pool3d(case):
    check_case("pool3d", {"X": f32(2, 2, 5, 5, 5)}, POOL3D[case], "Out",
               ["X"])


def test_conv3d_groups_and_dilation():
    check_case("conv3d", {"Input": f32(1, 4, 6, 6, 6),
                          "Filter": f32(6, 2, 2, 2, 2)},
               dict(groups=2, dilations=[2, 1, 2], paddings=[1, 0, 1]),
               "Output", ["Input", "Filter"])


def test_conv2d_transpose_dilated():
    check_case("conv2d_transpose", {"Input": f32(2, 3, 5, 4),
                                    "Filter": f32(3, 4, 3, 2)},
               dict(strides=[2, 3], paddings=[1, 0], dilations=[2, 1]),
               "Output", ["Input", "Filter"])


def test_max_pool_with_index_ties_take_the_first_maximum():
    """Equal values in a window: the mask names the first in scan order,
    and the gradient goes to that cell only."""
    x = np.zeros((1, 1, 4, 4), np.float32)
    x[0, 0, 1, 1] = x[0, 0, 1, 2] = 3.0
    check_case("max_pool2d_with_index", {"X": x},
               dict(ksize=[3, 3], strides=[1, 1], paddings=[1, 1]), "Out",
               ["X"])


def test_max_pool_with_index_global():
    check_case("max_pool2d_with_index", {"X": f32(2, 3, 5, 6)},
               dict(ksize=[1, 1], global_pooling=True), "Out", ["X"])


def test_unpool_drops_out_of_plane_indices():
    x = f32(1, 2, 2, 2)
    idx = np.array([[[[0, 5], [17, -1]], [[3, 99], [-20, 15]]]], np.int32)
    check_case("unpool", {"X": x, "Indices": idx},
               dict(unpooling_type="max", ksize=[2, 2], strides=[2, 2]),
               "Out", ["X"])


def test_soft_relu_saturated_gradient():
    x = np.array([[-3.0, -0.5, 0.7, 4.0]], np.float32)
    check_case("soft_relu", {"X": x}, dict(threshold=1.5), "Out", ["X"])


@pytest.mark.parametrize("shape", [(4, 3), (2, 3, 8, 8)])
def test_gaussian_random_noise_samples_are_the_jax_packages(shape):
    x = f32(*shape)
    j, t, _ = run_both("gaussian_random_noise", {"X": [x]}, dict(std=0.5),
                       seed=3)
    # the same threefry bits through erfinv: the last ulp may differ
    np.testing.assert_allclose(t["Out"][0], j["Out"][0], rtol=2e-5,
                               atol=1e-6)
    assert not np.allclose(t["Out"][0], x)


AA = {
    # nu 7 -> 8, window min(100, 4) = 4, na 3 -> 4: shift
    "shift": dict(na=3, ona=5, nu=7, attrs=dict(
        average_window=0.5, min_average_window=2, max_average_window=100)),
    # na 1 -> 2 below min window 5: accumulate only
    "accumulate": dict(na=1, ona=5, nu=3, attrs=dict(
        average_window=0.5, min_average_window=5, max_average_window=100)),
    # nu 15 -> 16 = k_max: sum_1 folds into sum_2
    "fold": dict(na=10, ona=0, nu=15, attrs=dict(
        average_window=1.0, min_average_window=1000,
        max_average_window=10000, k_max_num_accumulates=16)),
}


@pytest.mark.parametrize("case", sorted(AA))
def test_average_accumulates(case):
    c = AA[case]
    ins = {"Param": [f32(4, 3)], "InSum1": [f32(4, 3)],
           "InSum2": [f32(4, 3)], "InSum3": [f32(4, 3)],
           "InNumAccumulates": [np.array([c["na"]], np.int32)],
           "InOldNumAccumulates": [np.array([c["ona"]], np.int32)],
           "InNumUpdates": [np.array([c["nu"]], np.int32)]}
    j, t, _ = run_both("average_accumulates", ins, c["attrs"])
    for slot in ("OutNumAccumulates", "OutOldNumAccumulates",
                 "OutNumUpdates"):
        assert t[slot][0].dtype == np.int32, slot
        np.testing.assert_array_equal(t[slot][0], np.asarray(j[slot][0]))
    assert_same(j, t, slots=["OutSum1", "OutSum2", "OutSum3"], atol=1e-6,
                rtol=1e-6)


def test_the_port_registers_every_op_of_the_jax_package():
    assert tops() == jops()
    assert len(tops()) == 210
