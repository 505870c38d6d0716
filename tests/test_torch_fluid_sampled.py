"""The port's sampled-loss and metric kernels (`nce`,
`hierarchical_sigmoid`, `auc`) against the JAX package's on the CPU:
each kernel on the same numpy inputs and the same run key, with its
gradients (torch autograd vs jax.grad of the same weighted sum of the
outputs), then programs built by each package's fluid layers trained
5 steps from the same JAX startup weights (tests/torch_parity.py
`FluidPair`), with the gradients fetched through the executors.

The layers always create a bias (`bias_attr=False` is refused by both
packages' LayerHelper), so the bias-free cases run at the kernel level
and, through the executor, with the op's Bias input removed in both
programs.

The trainers run SGD: under Adam (the JAX tests' optimizer) an element
whose gradient is f32 rounding noise (~1e-9) takes an lr-sized step in
either package, and the parameters part by ~1e-4 after one step while
the gradients agree within 3e-8 (the `neg_distribution` case on the
CPU).

Tolerances: NCE `SampleLabels` identical (the same threefry bits in
both packages); f32 outputs and gradients within rtol 1e-5 / atol 1e-6
(reduction order only); losses over 5 steps within rtol 1e-5 and
parameters within 1e-5; AUC within 1e-6 (the same thresholds, counts
and trapezoid)."""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from paddle_tpu.fluid.core.registry import LoweringContext as JCtx
from paddle_tpu.fluid.core.registry import get_kernel as jkernel
from paddle_tpu_torch.fluid.core.registry import LoweringContext as TCtx
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel
from paddle_tpu_torch.utils import prng

torch.set_num_threads(2)

V, D, N = 40, 8, 16


def kernel_both(op_type, ins, attrs, grad_slots=(), out="Cost", seed=0):
    """(JAX outputs, port outputs, JAX grads, port grads) of one kernel
    call on the same inputs and run key; grads are of sum(out * r) for
    a fixed random r, by input slot."""
    op = types.SimpleNamespace(type=op_type, outputs={}, inputs={
        s: [s] for s in ins})
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    tkey = prng.fold_in(prng.PRNGKey(seed), 1)
    r = np.random.RandomState(seed + 1)

    def jrun(diff):
        ctx = JCtx(None, jkey)
        ctx.op = op
        full = {k: [jnp.asarray(v)] for k, v in ins.items()}
        full.update({k: [v] for k, v in diff.items()})
        return jkernel(op_type)(ctx, full, dict(attrs))

    jout = jrun({})
    weight = r.randn(*np.shape(jout[out])).astype(np.float32)
    jgrad = jax.grad(lambda d: jnp.sum(jrun(d)[out] * weight))(
        {k: jnp.asarray(ins[k]) for k in grad_slots})

    ctx = TCtx(None, tkey, "cpu")
    ctx.op = op
    tins = {k: [torch.from_numpy(np.array(v)).requires_grad_(k in
                                                            grad_slots)]
            for k, v in ins.items()}
    tout = tkernel(op_type)(ctx, tins, dict(attrs))
    tgrad = {}
    if grad_slots:
        gs = torch.autograd.grad((tout[out] * torch.from_numpy(weight)).sum(),
                                 [tins[k][0] for k in grad_slots])
        tgrad = dict(zip(grad_slots, gs))
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.detach().numpy() for k, v in tout.items()},
            {k: np.asarray(v) for k, v in jgrad.items()},
            {k: v.numpy() for k, v in tgrad.items()})


def assert_close(got, want, rtol=1e-5, atol=1e-6):
    for k in want:
        np.testing.assert_allclose(got[k].astype(np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=rtol, atol=atol, err_msg=k)


def nce_inputs(seed, num_true=1, bias=True, weight=False):
    rng = np.random.RandomState(seed)
    ins = dict(Input=rng.randn(N, D).astype(np.float32),
               Label=rng.randint(0, V, (N, num_true)).astype(np.int64),
               Weight=(0.3 * rng.randn(V, D)).astype(np.float32))
    if bias:
        ins["Bias"] = (0.1 * rng.randn(V, 1)).astype(np.float32)
    if weight:
        ins["SampleWeight"] = rng.uniform(0.5, 2, (N, 1)).astype(np.float32)
    return ins


NEG_DIST = list(np.random.RandomState(9).uniform(0, 1, V).round(4))
NEG_DIST[3] = 0.0  # a class that is never noise, but may be a label


@pytest.mark.parametrize("dist", [None, NEG_DIST], ids=["uniform", "dist"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("weight", [False, True], ids=["", "weighted"])
@pytest.mark.parametrize("num_true", [1, 2])
def test_nce_kernel_matches_jax(dist, bias, weight, num_true):
    ins = nce_inputs(num_true, num_true, bias, weight)
    if dist is not None:
        ins["Label"][:, 0] = 3  # the zero-probability class as a label
    attrs = dict(num_total_classes=V, num_neg_samples=7,
                 neg_distribution=dist)
    slots = ("Input", "Weight") + (("Bias",) if bias else ())
    jout, tout, jg, tg = kernel_both("nce", ins, attrs, slots)
    np.testing.assert_array_equal(tout["SampleLabels"],
                                  jout["SampleLabels"])
    assert tout["SampleLabels"].shape == (N, num_true + 7)
    assert_close(tout, {k: jout[k] for k in ("Cost", "SampleLogits")})
    assert_close(tg, jg)


@pytest.mark.parametrize("C", [8, 11], ids=["pow2", "not_pow2"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_hsigmoid_kernel_matches_jax(C, bias):
    rng = np.random.RandomState(C)
    ins = dict(X=rng.randn(N, D).astype(np.float32),
               W=(0.3 * rng.randn(C - 1, D)).astype(np.float32),
               Label=rng.randint(0, C, (N, 1)).astype(np.int64))
    ins["Label"][:2, 0] = [0, C - 1]
    if bias:
        ins["Bias"] = (0.1 * rng.randn(C - 1, 1)).astype(np.float32)
    slots = ("X", "W") + (("Bias",) if bias else ())
    jout, tout, jg, tg = kernel_both("hierarchical_sigmoid", ins,
                                     dict(num_classes=C), slots, out="Out")
    assert_close(tout, jout)
    assert_close(tg, jg)


@pytest.mark.parametrize("cols", [1, 2])
@pytest.mark.parametrize("seed", [0, 1])
def test_auc_kernel_matches_jax(cols, seed):
    rng = np.random.RandomState(seed)
    score = rng.uniform(0, 1, (64, cols)).astype(np.float32)
    score[:4, -1] = [0.0, 1.0, 0.5, 100 / 199.0]  # on thresholds
    label = (rng.uniform(0, 1, (64, 1)) < score[:, -1:]).astype(np.int64)
    jout, tout, _, _ = kernel_both("auc", dict(Out=score, Label=label),
                                   dict(num_thresholds=200), out="AUC")
    np.testing.assert_allclose(tout["AUC"], jout["AUC"], rtol=0, atol=1e-6)
    assert 0.5 < float(tout["AUC"][0]) <= 1.0


def _strip_bias(fluid, op_type):
    """Remove the Bias input of the program's `op_type` op (the layers
    always create one)."""
    for op in fluid.default_main_program().global_block().ops:
        if op.type == op_type:
            op.inputs.pop("Bias")


def nce_program(dist=None, bias=True, weight=False):
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[D], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        sw = fluid.layers.data(name="sw", shape=[1], dtype="float32") \
            if weight else None
        cost = fluid.layers.nce(input=x, label=y, num_total_classes=V,
                                num_neg_samples=8, sample_weight=sw,
                                neg_distribution=dist)
        if not bias:
            _strip_bias(fluid, "nce")
        loss = fluid.layers.mean(x=cost)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        block = fluid.default_main_program().global_block()
        nce = [op for op in block.ops if op.type == "nce"][0]
        out = dict(loss=loss,
                   labels=block.var(nce.outputs["SampleLabels"][0]),
                   logits=block.var(nce.outputs["SampleLogits"][0]))
        for slot in ("Weight", "Bias"):
            if nce.inputs.get(slot):
                out[slot] = block.var(nce.inputs[slot][0] + "@GRAD")
        return out
    return build


def nce_feed(seed=3, weight=False):
    rng = np.random.RandomState(seed)
    x = rng.randn(32, D).astype(np.float32)
    feed = dict(x=x, y=((np.abs(x.sum(1)) * 7).astype(np.int64) % V
                        ).reshape(-1, 1))
    if weight:
        feed["sw"] = rng.uniform(0.5, 2, (32, 1)).astype(np.float32)
    return feed


def hsigmoid_program(C, bias=True):
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[6], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        cost = fluid.layers.hsigmoid(input=x, label=y, num_classes=C)
        if not bias:
            _strip_bias(fluid, "hierarchical_sigmoid")
        loss = fluid.layers.mean(x=cost)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        block = fluid.default_main_program().global_block()
        hs = [op for op in block.ops if op.type == "hierarchical_sigmoid"][0]
        out = dict(loss=loss)
        for slot in ("W", "Bias"):
            if hs.inputs.get(slot):
                out[slot] = block.var(hs.inputs[slot][0] + "@GRAD")
        return out
    return build


def hsigmoid_feed(C, seed=4):
    rng = np.random.RandomState(seed)
    centers = rng.randn(C, 6).astype(np.float32) * 2
    y = rng.randint(0, C, 64)
    x = centers[y] + 0.1 * rng.randn(64, 6).astype(np.float32)
    return dict(x=x, y=y.reshape(-1, 1).astype(np.int64))


def train_both(build, feed, fetch, steps=5):
    """5 steps of a FluidPair with the port's run counter aligned to the
    JAX executor's (the run key each random op folds into)."""
    pair = tp.FluidPair(build)
    pair.texe._run_counter = pair.jexe._run_counter
    runs = [pair.run(feed, fetch) for _ in range(steps)]
    return pair, runs


@pytest.mark.parametrize("case", ["uniform", "uniform_nobias",
                                  "uniform_weighted", "dist",
                                  "dist_nobias_weighted"])
def test_nce_trains_like_jax(case):
    dist = NEG_DIST if case.startswith("dist") else None
    bias, weight = "nobias" not in case, "weighted" in case
    build = nce_program(dist, bias, weight)
    grads = ["Weight"] + (["Bias"] if bias else [])
    pair, runs = train_both(build, nce_feed(weight=weight),
                            ["loss", "labels", "logits"] + grads)
    for j, t in runs:
        np.testing.assert_array_equal(t[1], j[1])  # SampleLabels
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        for a, b in zip(j[2:], t[2:]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert max(pair.state_diff().values()) < 1e-5
    # the labels draw new noise every run
    assert not np.array_equal(runs[0][1][1], runs[1][1][1])


@pytest.mark.parametrize("C", [8, 11], ids=["pow2", "not_pow2"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_hsigmoid_trains_like_jax(C, bias):
    grads = ["W"] + (["Bias"] if bias else [])
    pair, runs = train_both(hsigmoid_program(C, bias), hsigmoid_feed(C),
                            ["loss"] + grads)
    for j, t in runs:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        for a, b in zip(j[1:], t[1:]):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert max(pair.state_diff().values()) < 1e-5
    assert runs[-1][1][0] < runs[0][1][0]


def test_auc_in_a_training_program_matches_jax():
    """auc as the CTR programs fetch it: over a sigmoid head trained 5
    steps, each step's AUC equal across the packages."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[D], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        logit = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.sigmoid_cross_entropy_with_logits(x=logit,
                                                             label=y))
        prob = fluid.layers.sigmoid(logit)
        auc = fluid.layers.auc(input=prob, label=y)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return dict(loss=loss, auc=auc)

    rng = np.random.RandomState(5)
    x = rng.randn(128, D).astype(np.float32)
    y = (x[:, :2].sum(1, keepdims=True) + 0.5 * rng.randn(128, 1)
         > 0).astype(np.float32)
    _, runs = train_both(build, dict(x=x, y=y), ["loss", "auc"])
    for j, t in runs:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        np.testing.assert_allclose(t[1], j[1], rtol=0, atol=1e-6)
    assert runs[-1][1][1] > runs[0][1][1]
