"""The Fluid `flash_attention` op of the port against the JAX package's
(Pallas in interpret mode on the CPU): the programs of
tests/test_fluid_flash_attention.py, the same inputs and JAX startup
weights. On the CPU the port's op runs the flash kernels' plain
versions; on the card the same op launches the kernels (chip_smoke.py).

Tolerances: forward outputs within atol 2e-5 (the JAX test's own bar
against reference attention); the first step's gradient of every
parameter within atol 1e-6 + rtol 1e-5, and losses within rtol 1e-4 over
3 Adam steps. Weights are not compared after Adam steps: the key
projection's bias has an analytically zero gradient (softmax is
shift-invariant in the keys), so each package feeds Adam its own ~1e-9
rounding noise there, which Adam normalises to steps of up to the
learning rate."""

import numpy as np
import torch

import torch_parity as tp

torch.set_num_threads(2)

SHAPE = [16, 2, 8]  # [T, H, D] per example


def _forward(fluid, resnet):
    q, k, v = (fluid.layers.data(name=n, shape=SHAPE, dtype="float32")
               for n in ("q", "k", "v"))
    return dict(causal=fluid.layers.flash_attention(q, k, v, causal=True),
                full=fluid.layers.flash_attention(q, k, v),
                scaled=fluid.layers.flash_attention(q, k, v, causal=True,
                                                    scale=0.2))


def test_flash_op_forward_matches_the_jax_op():
    pair = tp.FluidPair(_forward)
    rng = np.random.RandomState(0)
    feed = {n: rng.randn(2, *SHAPE).astype(np.float32)
            for n in ("q", "k", "v")}
    j, t = pair.run(feed, ["causal", "full", "scaled"])
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, atol=2e-5)


def _trainer(fluid, resnet):
    """tests/test_fluid_flash_attention.py::test_flash_layer_trains."""
    x = fluid.layers.data(name="x", shape=[16, 8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    proj = fluid.layers.fc(input=x, size=48, num_flatten_dims=2)

    def split(lo, hi):
        s = fluid.layers.slice(proj, axes=[2], starts=[lo], ends=[hi])
        return fluid.layers.reshape(s, [-1, 16, 2, 8])

    o = fluid.layers.flash_attention(split(0, 16), split(16, 32),
                                     split(32, 48), causal=True)
    o = fluid.layers.reshape(o, [-1, 16 * 16])
    pred = fluid.layers.fc(input=o, size=1)
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.Adam(learning_rate=1e-2).minimize(loss)
    return dict(loss=loss)


def test_flash_op_trains_like_the_jax_op():
    pair = tp.FluidPair(_trainer)
    rng = np.random.RandomState(1)
    feed = dict(x=rng.randn(4, 16, 8).astype(np.float32),
                y=rng.randn(4, 1).astype(np.float32))
    grads = sorted(n for n in pair.names if n.endswith("@GRAD"))
    assert len(grads) == 4
    with tp.JF.scope_guard(pair.jscope):
        j = pair.jexe.run(pair.jmain, feed=feed,
                          fetch_list=[pair.jvars["loss"]] + grads)
    with tp.TF.scope_guard(pair.tscope):
        t = pair.texe.run(pair.tmain, feed=feed,
                          fetch_list=[pair.tvars["loss"]]
                          + [pair.names[n] for n in grads])
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=1e-5)
    losses = [float(t[0][0])]
    for _ in range(2):
        j, t = pair.run(feed, ["loss"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
        losses.append(float(t[0][0]))
    assert losses[-1] < losses[0]
