"""The `lrn` kernel and the image model zoo (LeNet, the MLP, VGG-16 with
batch norm and dropout, plain VGG-16, AlexNet, GoogLeNet, MobileNet v1)
of the port against the JAX package on the CPU.

Tolerances: `lrn` forward and gradient within rtol 1e-5 (atol 1e-6) in
f32, 2e-2 in bf16 (bf16 keeps ~3 significant digits); the zoo's losses
within rtol 1e-4 and the model's state (parameters and batch-norm
running statistics) within atol 1e-4 after 1-3 Momentum steps from the
same JAX startup weights (reduction order only; optimizer state is not
held, as in tests/test_torch_fluid_executor.py). Images are zero-mean,
as the book normalises them: on all-positive images the batch-norm
variance E[x^2] - E[x]^2 (the JAX formula, kept) cancels after the first
conv and amplifies reduction-order error (tests/test_torch_fluid_executor.py).
The batch-norm models take batches that give each channel's statistics
at least 16 values. MobileNet takes one step: its 27 batch norms at
lr 0.01 carry large gradients into the first conv and amplify the
packages' reduction-order difference about twofold per block, so a
second step compares two trajectories that have already parted."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from test_torch_fluid_ops import run_both, _op
from paddle_tpu.fluid.core.registry import LoweringContext as JCtx
from paddle_tpu.fluid.core.registry import get_kernel as jkernel
from paddle_tpu.models import alexnet as JA, googlenet as JG, \
    lenet as JL, mobilenet as JM, vgg as JV
from paddle_tpu_torch.fluid.core.registry import LoweringContext as TCtx
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel
from paddle_tpu_torch.models import alexnet as TA, googlenet as TG, \
    lenet as TL, mobilenet as TM, vgg as TV
from paddle_tpu_torch.utils import prng

torch.set_num_threads(2)


def vjp_both(op_type, ins, attrs, wrt, out, lods=None, dtype=None,
             seed=0):
    """(JAX outputs, port outputs, JAX input gradients, port input
    gradients): the kernel's output slot `out` pulled back through each
    package's autodiff (jax.vjp, torch.autograd) with one seeded
    cotangent, to the input slots `wrt`. `lods` maps an input variable
    name to its offsets (the port also gets their host copy); `dtype`
    ("bfloat16") casts the float inputs in both packages first."""
    op = _op(ins)
    op.type = op_type
    op.outputs = {out: [out]}
    side = {n + "@LOD0": np.asarray(o, np.int32)
            for n, o in (lods or {}).items()}
    jctx = JCtx(None, jax.random.PRNGKey(seed))
    tctx = TCtx(None, prng.PRNGKey(seed), "cpu")
    jctx.op = tctx.op = op
    jctx.env = {k: jnp.asarray(v) for k, v in side.items()}
    tctx.env = {k: torch.from_numpy(v.copy()) for k, v in side.items()}
    tctx.has_lod = bool(side)
    for k, v in side.items():
        tctx.note_host_lod(tctx.env[k], v)

    def jcast(a):
        a = jnp.asarray(a)
        return a.astype(jnp.bfloat16) if dtype and a.dtype.kind == "f" \
            else a

    def tcast(a):
        t = torch.from_numpy(np.array(a))
        return t.bfloat16() if dtype and t.is_floating_point() else t

    jins = {k: [jcast(a) for a in v] for k, v in ins.items()}
    tins = {k: [tcast(a) for a in v] for k, v in ins.items()}

    def jf(*xs):
        d = dict(jins)
        for k, x in zip(wrt, xs):
            d[k] = [x]
        return jkernel(op_type)(jctx, d, dict(attrs))[out]

    jy, pull = jax.vjp(jf, *[jins[k][0] for k in wrt])
    cot = np.random.RandomState(seed + 1).randn(*jy.shape).astype(
        np.float32)
    jg = pull(jnp.asarray(cot).astype(jy.dtype))
    leaves = [tins[k][0].requires_grad_(True) for k in wrt]
    ty = tkernel(op_type)(tctx, tins, dict(attrs))[out]
    tg = torch.autograd.grad(ty, leaves,
                             torch.from_numpy(cot).to(ty.dtype))

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
            if not isinstance(x, torch.Tensor) \
            else x.detach().float().numpy()

    return f32(jy), f32(ty), [f32(g) for g in jg], [f32(g) for g in tg]


# --- lrn -----------------------------------------------------------------

LRN_CASES = {
    "n3_k2": dict(n=3, k=2.0, alpha=1e-4, beta=0.75),
    "n5_k2": dict(n=5, k=2.0, alpha=1e-4, beta=0.75),
    # the layer's default k (layers/nn.py lrn), a larger alpha so the
    # window sum matters
    "n5_k1": dict(n=5, k=1.0, alpha=1e-2, beta=0.75),
    "n3_k1": dict(n=3, k=1.0, alpha=1e-2, beta=0.5),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LRN_CASES))
def test_lrn_forward_and_gradient(case, dtype):
    x = np.random.RandomState(0).randn(2, 7, 5, 4).astype(np.float32) * 3
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    jy, ty, jg, tg = vjp_both("lrn", {"X": [x]}, LRN_CASES[case], ["X"],
                              "Out", dtype=dtype if dtype != "float32"
                              else None)
    assert ty.shape == jy.shape == x.shape
    np.testing.assert_allclose(ty, jy, **tol)
    np.testing.assert_allclose(tg[0], jg[0], **tol)
    if dtype == "float32":
        j, t, _ = run_both("lrn", {"X": [x]}, LRN_CASES[case])
        np.testing.assert_allclose(t["MidOut"][0], j["MidOut"][0],
                                   rtol=1e-5)


def test_lrn_layer_default_k_reaches_the_kernel():
    """layers.lrn passes its own k (1.0) through the op's attrs: the
    kernel's default (2.0) applies only to an op built without one."""
    main, startup = tp.TF.Program(), tp.TF.Program()
    with tp.TF.program_guard(main, startup):
        x = tp.TF.layers.data(name="x", shape=[4, 3, 3], dtype="float32")
        y = tp.TF.layers.lrn(input=x, n=3, alpha=0.5)
    assert main.global_block().ops[-1].attrs["k"] == 1.0
    feed = np.full((1, 4, 3, 3), 2.0, np.float32)
    (out,) = tp.TF.Executor(tp.TF.CPUPlace()).run(
        main, feed=dict(x=feed), fetch_list=[y])
    # an inner channel's window holds 3 channels of 4.0: 1 + 0.5 * 12
    np.testing.assert_allclose(out[0, 1], 2.0 * 7.0 ** -0.75, rtol=1e-6)


# --- the zoo through each package's Executor ------------------------------

ZOO = {
    # name: (JAX model function, port model function, input shape,
    #        batch, steps)
    "lenet": (JL.lenet, TL.lenet, [1, 28, 28], 4, 3),
    "mlp": (JL.mlp, TL.mlp, [1, 28, 28], 4, 3),
    "vgg16_bn_drop": (JV.vgg16_bn_drop, TV.vgg16_bn_drop, [3, 32, 32], 8, 2),
    "vgg16": (JV.vgg16, TV.vgg16, [3, 32, 32], 2, 1),
    "alexnet": (JA.alexnet, TA.alexnet, [3, 64, 64], 2, 1),
    "googlenet": (JG.googlenet, TG.googlenet, [3, 32, 32], 2, 2),
    "mobilenet_v1_x0.25": (lambda x, c: JM.mobilenet_v1(x, c, scale=0.25),
                           lambda x, c: TM.mobilenet_v1(x, c, scale=0.25),
                           [3, 64, 64], 4, 1),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_trains_like_the_jax_executor(name):
    jbuild, tbuild, shape, batch, steps = ZOO[name]

    def build(fluid, resnet):
        img = fluid.layers.data(name="img", shape=shape, dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        model = jbuild if fluid is tp.JF else tbuild
        pred = model(img, 10)
        loss = fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=pred, label=lbl))
        fluid.optimizer.Momentum(learning_rate=0.01,
                                 momentum=0.9).minimize(loss)
        return dict(loss=loss)

    pair = tp.FluidPair(build)
    rng = np.random.RandomState(1)
    feed = dict(img=rng.randn(batch, *shape).astype(np.float32),
                lbl=rng.randint(0, 10, (batch, 1)).astype(np.int64))
    for _ in range(steps):
        # dropout draws from the run key, which folds in the run count
        pair.texe._run_counter = pair.jexe._run_counter
        j, t = pair.run(feed, ["loss"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    diff = pair.state_diff()
    bad = sorted((d, n) for n, d in diff.items()
                 if n in pair.model_state_names() and d > 1e-4)
    assert not bad, bad[-3:]
    if name == "googlenet":
        ops = [op.type for op in pair.tmain.global_block().ops]
        assert ops.count("lrn") == 2
