"""Each ported Fluid op kernel against the JAX package's kernel of the same
op on the same numpy inputs (from a seed), called directly through each
package's registry on the CPU.

Tolerances: f32 outputs within atol/rtol 1e-5 (reduction order only);
uniform draws bit-identical; normal draws within rtol 2e-5 / atol 1e-6
(torch's erfinv vs XLA's, a few ulp; more in the far tails); the AMP
deny-list case compares bf16 values at atol 1e-2 (bf16 rounding)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid.core import lowering as jlow
from paddle_tpu.fluid.core.registry import LoweringContext as JCtx
from paddle_tpu.fluid.core.registry import get_kernel as jkernel
from paddle_tpu_torch.fluid.core import lowering as tlow
from paddle_tpu_torch.fluid.core.registry import LoweringContext as TCtx
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel
from paddle_tpu_torch.utils import prng

import torch_parity as tp

torch.set_num_threads(2)


def _names(slot, vals):
    """Variable names of an input slot: "s", or "s0", "s1", ... when the
    slot holds several tensors."""
    return [slot] if len(vals) == 1 else ["%s%d" % (slot, i)
                                          for i in range(len(vals))]


def _op(ins, aliases=(), outs=()):
    """A stand-in Operator: input slot s holds variable "s" (_names); an
    output slot named in `aliases` writes its input's variable (in
    place), one named in `outs` writes variable "s"."""
    outputs = {o: [i] for o, i in aliases}
    outputs.update({o: [o] for o in outs})
    return types.SimpleNamespace(
        type=None, inputs={s: _names(s, v) for s, v in ins.items()},
        outputs=outputs)


def run_both(op_type, ins, attrs, seed=0, aliases=(), is_test=False,
             lods=None, outs=(), env=None, host=True, keep=()):
    """(JAX outputs, port outputs, port inputs), each {slot: [numpy]}.

    LoD: `lods` maps an input variable name (see _op) to its offsets, and
    `env` other side-band entries by key; both go into each context's
    environment. The port also gets the host copy of every `lods` entry
    (as its executor registers fed offsets) unless `host` is False.
    Output slots named in `outs` come back with their side-bands under
    "<slot>@LOD0". `keep` names variables the run reads afterwards."""
    jctx = JCtx(None, jax.random.fold_in(jax.random.PRNGKey(seed), 1),
                is_test=is_test)
    tctx = TCtx(None, prng.fold_in(prng.PRNGKey(seed), 1), "cpu",
                is_test=is_test)
    op = _op(ins, aliases, outs)
    op.type = op_type
    jctx.op = tctx.op = op
    side = {n + "@LOD0": np.asarray(o, np.int32)
            for n, o in (lods or {}).items()}
    side.update(env or {})
    jctx.env = {k: jnp.asarray(v) for k, v in side.items()}
    tctx.env = {k: torch.from_numpy(np.array(v)) for k, v in side.items()}
    tctx.has_lod = bool(side)
    tctx.keep = keep
    if host:
        for n in lods or {}:
            tctx.note_host_lod(tctx.env[n + "@LOD0"], side[n + "@LOD0"])
    jout = jkernel(op_type)(jctx, {k: [jnp.asarray(a) for a in v]
                                   for k, v in ins.items()}, dict(attrs))
    tins = {k: [torch.from_numpy(np.array(a)) for a in v]
            for k, v in ins.items()}
    tout = tkernel(op_type)(tctx, tins, dict(attrs))
    for o in outs:
        key = o + "@LOD0"
        if key in jctx.env:
            jout[key] = jctx.env[key]
        if key in tctx.env:
            tout[key] = tctx.env[key]

    def norm(d, f):
        return {k: [f(x) for x in (v if isinstance(v, (list, tuple))
                                   else [v])] for k, v in d.items()}

    return (norm(jout, lambda x: np.asarray(x)),
            norm(tout, lambda x: x.detach().float().numpy()
                 if x.dtype == torch.bfloat16 else x.detach().numpy()),
            tins)


def assert_same(jout, tout, slots=None, atol=1e-5, rtol=1e-5):
    for slot in slots or jout:
        for a, b in zip(jout[slot], tout[slot]):
            a = np.asarray(a, np.float32) if a.dtype.kind == "V" else a
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            np.testing.assert_allclose(b.astype(np.float64),
                                       a.astype(np.float64), atol=atol,
                                       rtol=rtol, err_msg=slot)


R = np.random.RandomState(0)


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


CONV = {
    "stride2_pad1": dict(x=(2, 4, 9, 9), w=(6, 4, 3, 3),
                         attrs=dict(strides=[2, 2], paddings=[1, 1])),
    "pad0_dilation2": dict(x=(2, 3, 10, 10), w=(5, 3, 3, 3),
                           attrs=dict(dilations=[2, 2])),
    "groups2": dict(x=(2, 4, 8, 8), w=(6, 2, 3, 3),
                    attrs=dict(groups=2, paddings=[1, 1])),
    "1x1_stride2": dict(x=(2, 4, 8, 8), w=(8, 4, 1, 1),
                        attrs=dict(strides=[2, 2])),
}


@pytest.mark.parametrize("case", sorted(CONV))
def test_conv2d(case):
    c = CONV[case]
    j, t, _ = run_both("conv2d", {"Input": [f32(*c["x"])],
                                  "Filter": [f32(*c["w"])]}, c["attrs"])
    assert_same(j, t, atol=1e-4)


def test_depthwise_conv2d():
    j, t, _ = run_both("depthwise_conv2d", {"Input": [f32(2, 4, 8, 8)],
                                            "Filter": [f32(4, 1, 3, 3)]},
                       dict(paddings=[1, 1]))
    assert_same(j, t, atol=1e-4)


POOL = {
    "max_k3_s2_p1": dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
                         paddings=[1, 1]),
    "max_ceil": dict(pooling_type="max", ksize=[3, 3], strides=[2, 2],
                     ceil_mode=True),
    "max_pad_over_half_window": dict(pooling_type="max", ksize=[3, 3],
                                     strides=[1, 1], paddings=[2, 2]),
    "avg_exclusive_p1": dict(pooling_type="avg", ksize=[3, 3],
                             strides=[2, 2], paddings=[1, 1]),
    "avg_inclusive_p1": dict(pooling_type="avg", ksize=[3, 3],
                             strides=[2, 2], paddings=[1, 1],
                             exclusive=False),
    "avg_exclusive_ceil_p1": dict(pooling_type="avg", ksize=[3, 3],
                                  strides=[2, 2], paddings=[1, 1],
                                  ceil_mode=True),
    "avg_inclusive_ceil": dict(pooling_type="avg", ksize=[3, 3],
                               strides=[2, 2], ceil_mode=True,
                               exclusive=False),
    "avg_global": dict(pooling_type="avg", ksize=[1, 1],
                       global_pooling=True),
    "max_global": dict(pooling_type="max", ksize=[1, 1],
                       global_pooling=True),
}


@pytest.mark.parametrize("case", sorted(POOL))
def test_pool2d(case):
    j, t, _ = run_both("pool2d", {"X": [f32(2, 3, 8, 8)]}, POOL[case])
    assert_same(j, t)


def test_pool2d_bf16_avg_sums_in_f32():
    x = f32(2, 3, 8, 8)
    attrs = POOL["avg_exclusive_ceil_p1"]
    jout = jkernel("pool2d")(JCtx(None, None), {"X": [jnp.asarray(
        x, jnp.bfloat16)]}, attrs)["Out"]
    tout = tkernel("pool2d")(TCtx(None, None, "cpu"), {"X": [torch.from_numpy(
        x).to(torch.bfloat16)]}, attrs)["Out"]
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout, np.float32), atol=1e-2)


@pytest.mark.parametrize("is_test", [False, True])
def test_batch_norm(is_test):
    x = f32(4, 3, 5, 5) * 2.0 + 1.5
    ins = {"X": [x], "Scale": [f32(3)], "Bias": [f32(3)],
           "Mean": [f32(3) * 0.1], "Variance": [np.abs(f32(3)) + 0.5]}
    attrs = dict(momentum=0.9, epsilon=1e-5, is_test=is_test)
    j, t, _ = run_both("batch_norm", ins, attrs)
    assert_same(j, t, atol=1e-5, rtol=1e-5)
    if not is_test:
        xs = x.astype(np.float64)
        mean = xs.mean(axis=(0, 2, 3))
        var = (xs ** 2).mean(axis=(0, 2, 3)) - mean ** 2  # biased
        np.testing.assert_allclose(t["MeanOut"][0], ins["Mean"][0] * 0.9
                                   + mean * 0.1, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(t["VarianceOut"][0],
                                   ins["Variance"][0] * 0.9 + var * 0.1,
                                   rtol=1e-5, atol=1e-6)
        # SavedVariance is the inverse std
        np.testing.assert_allclose(t["SavedVariance"][0],
                                   1.0 / np.sqrt(var + 1e-5), rtol=1e-5)


def test_layer_norm():
    j, t, _ = run_both("layer_norm", {"X": [f32(3, 4, 5)],
                                      "Scale": [f32(20)], "Bias": [f32(20)]},
                       dict(begin_norm_axis=1))
    assert_same(j, t)


ELEMENTWISE = {
    "add_axis1_bias": ("elementwise_add", (2, 3, 4, 4), (3,), 1),
    "mul_axis0": ("elementwise_mul", (2, 3, 4), (2, 3), 0),
    "sub_trailing": ("elementwise_sub", (2, 3, 4), (3, 4), -1),
    "div_same_shape": ("elementwise_div", (2, 3), (2, 3), -1),
    "max_axis1": ("elementwise_max", (2, 3, 4), (3,), 1),
}


@pytest.mark.parametrize("case", sorted(ELEMENTWISE))
def test_elementwise_axis_broadcast(case):
    op, xs, ys, axis = ELEMENTWISE[case]
    y = f32(*ys)
    if op == "elementwise_div":
        y = np.abs(y) + 0.5
    j, t, _ = run_both(op, {"X": [f32(*xs)], "Y": [y]}, dict(axis=axis))
    assert_same(j, t)


@pytest.mark.parametrize("x,y,xn", [((2, 3, 4), (4, 5), 2),
                                    ((2, 3, 4), (12, 5), 1),
                                    ((6, 7), (7, 2), 1)])
def test_mul_flattens_by_num_col_dims(x, y, xn):
    j, t, _ = run_both("mul", {"X": [f32(*x)], "Y": [f32(*y)]},
                       dict(x_num_col_dims=xn, y_num_col_dims=1))
    assert_same(j, t)


def test_matmul_transposed_scaled():
    j, t, _ = run_both("matmul", {"X": [f32(2, 4, 3)], "Y": [f32(2, 5, 4)]},
                       dict(transpose_X=True, transpose_Y=True, alpha=0.5))
    assert_same(j, t)


@pytest.mark.parametrize("op,attrs", [
    ("reduce_sum", dict(dim=[1], keep_dim=True)),
    ("reduce_mean", dict(reduce_all=True)),
    ("reduce_max", dict(dim=-1)),
    ("reduce_prod", dict(dim=[0, 2])),
    ("mean", {}), ("scale", dict(scale=2.5, bias=0.5)),
    ("relu", {}), ("sigmoid", {}), ("tanh", {}), ("gelu", {}),
    ("softplus", {}), ("leaky_relu", dict(alpha=0.1)), ("sqrt", {}),
    ("softmax", {}), ("log_softmax", {}), ("square", {}),
    ("clip", dict(min=-0.5, max=0.5)), ("cast", dict(out_dtype="int32")),
])
def test_math_and_activation_ops(op, attrs):
    x = f32(3, 4, 5)
    if op == "sqrt":
        x = np.abs(x)
    j, t, _ = run_both(op, {"X": [x]}, attrs)
    assert_same(j, t)


def test_cross_entropy_takes_probabilities():
    p = np.asarray(torch.softmax(torch.from_numpy(f32(6, 10)), -1))
    label = R.randint(0, 10, (6, 1)).astype(np.int64)
    j, t, _ = run_both("cross_entropy", {"X": [p], "Label": [label]}, {})
    assert_same(j, t)
    np.testing.assert_allclose(
        t["Y"][0][:, 0], -np.log(p[np.arange(6), label[:, 0]] + 1e-8),
        rtol=1e-6)
    soft = np.asarray(torch.softmax(torch.from_numpy(f32(6, 10)), -1))
    j, t, _ = run_both("cross_entropy", {"X": [p], "Label": [soft]},
                       dict(soft_label=True))
    assert_same(j, t)


def test_softmax_with_cross_entropy_and_accuracy():
    label = R.randint(0, 10, (6, 1)).astype(np.int64)
    j, t, _ = run_both("softmax_with_cross_entropy",
                       {"Logits": [f32(6, 10)], "Label": [label]}, {})
    assert_same(j, t)
    j, t, _ = run_both("top_k", {"X": [f32(6, 10)]}, dict(k=3))
    assert_same(j, t)
    j, t, _ = run_both("accuracy", {"Indices": [t["Indices"][0]],
                                    "Label": [label]}, {})
    assert_same(j, t)


OPTIM = {
    "sgd": ({}, ["Param"], {}),
    "momentum": ({"Velocity": 0.1}, ["Param", "Velocity"], dict(mu=0.9)),
    "momentum_nesterov": ({"Velocity": 0.1}, ["Param", "Velocity"],
                          dict(mu=0.9, use_nesterov=True)),
    "adagrad": ({"Moment": 0.1}, ["Param", "Moment"], {}),
    "adam": ({"Moment1": 0.1, "Moment2": 0.01, "Beta1Pow": 0.81,
              "Beta2Pow": 0.998}, ["Param", "Moment1", "Moment2"], {}),
    "adamax": ({"Moment": 0.1, "InfNorm": 0.2, "Beta1Pow": 0.81},
               ["Param", "Moment", "InfNorm"], {}),
    "decayed_adagrad": ({"Moment": 0.1}, ["Param", "Moment"], {}),
    "rmsprop": ({"MeanSquare": 0.1, "Moment": 0.05},
                ["Param", "MeanSquare", "Moment"], dict(momentum=0.5)),
    "adadelta": ({"AvgSquaredGrad": 0.1, "AvgSquaredUpdate": 0.05},
                 ["Param", "AvgSquaredGrad", "AvgSquaredUpdate"], {}),
    "ftrl": ({"SquaredAccumulator": 0.1, "LinearAccumulator": 0.05},
             ["Param", "SquaredAccumulator", "LinearAccumulator"],
             dict(l1=0.01, l2=0.01)),
    "proximal_gd": ({}, ["Param"], dict(l1=0.01, l2=0.01)),
    "proximal_adagrad": ({"Moment": 0.1}, ["Param", "Moment"],
                         dict(l1=0.01, l2=0.01)),
}
_OUT = {"SquaredAccumulator": "SquaredAccumOut",
        "LinearAccumulator": "LinearAccumOut"}


@pytest.mark.parametrize("name", sorted(OPTIM))
def test_optimizer_dense_update_in_place(name):
    state, updated, attrs = OPTIM[name]
    op = name.split("_nesterov")[0]
    ins = {"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
           "LearningRate": [np.asarray([0.1], np.float32)]}
    for slot, scale in state.items():
        shape = (1,) if "Pow" in slot else (4, 3)
        ins[slot] = [(np.abs(f32(*shape)) * scale + scale).astype(np.float32)
                     if "Pow" not in slot
                     else np.asarray([scale], np.float32)]
    aliases = [(_OUT.get(s, s + "Out"), s) for s in updated]
    j, t, tins = run_both(op, ins, attrs, aliases=aliases)
    assert_same(j, t, slots=[o for o, _ in aliases], atol=1e-6, rtol=1e-5)
    # the scope's own tensors were written
    for out_slot, in_slot in aliases:
        np.testing.assert_array_equal(tins[in_slot][0].numpy(),
                                      t[out_slot][0])


def test_optimizer_copies_when_output_names_another_variable():
    ins = {"Param": [f32(4, 3)], "Grad": [f32(4, 3)],
           "LearningRate": [np.asarray([0.1], np.float32)]}
    before = ins["Param"][0].copy()
    j, t, tins = run_both("sgd", ins, {})  # ParamOut is not aliased
    np.testing.assert_array_equal(tins["Param"][0].numpy(), before)
    assert_same(j, t)


@pytest.mark.parametrize("attrs", [
    dict(shape=[64, 7], min=-1.0, max=1.0),
    dict(shape=[13, 5], min=-0.2, max=0.6),
    dict(shape=[33], min=-0.3, max=0.7),  # span 1: XLA's folded form
    dict(shape=[9, 9], min=-0.5, max=0.5, seed=11),
])
def test_uniform_random_is_bit_identical(attrs):
    j, t, _ = run_both("uniform_random", {}, dict(attrs, dtype="float32"),
                       seed=3)
    jit = jax.jit(lambda k: jkernel("uniform_random")(
        JCtx(None, k), {}, dict(attrs, dtype="float32"))["Out"])
    a = np.asarray(jit(jax.random.fold_in(jax.random.PRNGKey(3), 1)))
    assert np.array_equal(t["Out"][0].view(np.int32), a.view(np.int32))
    assert t["Out"][0].shape == tuple(attrs["shape"])


@pytest.mark.parametrize("op", ["gaussian_random",
                                "truncated_gaussian_random"])
def test_normal_draws_from_the_same_key(op):
    attrs = dict(shape=[128, 9], mean=0.5, std=2.0, dtype="float32")
    j, t, _ = run_both(op, {}, attrs, seed=4)
    np.testing.assert_allclose(t["Out"][0], j["Out"][0], rtol=2e-5,
                               atol=1e-6)
    if op == "truncated_gaussian_random":
        assert np.abs(t["Out"][0] - 0.5).max() < 4.0


def test_dropout_mask_is_the_jax_mask():
    x = f32(16, 32)
    j, t, _ = run_both("dropout", {"X": [x]}, dict(dropout_prob=0.3),
                       seed=5)
    np.testing.assert_array_equal(t["Mask"][0], j["Mask"][0])
    assert_same(j, t)


def test_amp_deny_list_runs_in_f32():
    """softmax -> cross_entropy -> mean inside a bf16 region: upcast to
    f32, softmax downcast back to bf16, the sticky loss-head ops stay f32,
    as the JAX package's _run_op_f32."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[10], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        p = fluid.layers.softmax(x)
        loss = fluid.layers.mean(x=fluid.layers.cross_entropy(input=p,
                                                              label=y))
        return dict(p=p, loss=loss)

    pair = tp.FluidPair(build)
    x = f32(6, 10)
    y = R.randint(0, 10, (6, 1))
    jenv = {"x": jnp.asarray(x, jnp.bfloat16),
            "y": jnp.asarray(y, jnp.int32)}
    tenv = {"x": torch.from_numpy(x).to(torch.bfloat16),
            "y": torch.from_numpy(y)}
    jctx = JCtx(pair.jmain.global_block(), None)
    tctx = TCtx(pair.tmain.global_block(), None, "cpu")
    jctx.amp_region = tctx.amp_region = True
    jlow.run_ops(jctx, pair.jmain.global_block().ops, jenv)
    tlow.run_ops(tctx, pair.tmain.global_block().ops, tenv)
    for key in ("p", "loss"):
        jn, tn = pair.jvars[key].name, pair.tvars[key].name
        assert str(tenv[tn].dtype).split(".")[-1] == str(jenv[jn].dtype)
        np.testing.assert_allclose(tenv[tn].float().numpy(),
                                   np.asarray(jenv[jn], np.float32),
                                   atol=1e-2)
    assert tenv[pair.tvars["p"].name].dtype == torch.bfloat16
    assert tenv[pair.tvars["loss"].name].dtype == torch.float32
