"""Model directories cross between the packages: what
`paddle_tpu.fluid.io.save_inference_model` writes, the port loads and
infers with, and the reverse (one .npy per persistable and the JSON
program IR on both sides).

Tolerance: inference outputs within atol 1e-5 (f32, reduction order)."""

import numpy as np
import torch

import torch_parity as tp
from torch_parity import JF, TF

torch.set_num_threads(2)


def _net(fluid, resnet):
    img = fluid.layers.data(name="img", shape=[1, 12, 12], dtype="float32")
    lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
    c = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                            padding=1)
    h = fluid.layers.batch_norm(input=c, act="relu")
    p = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(input=p, size=5, act="softmax")
    loss = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=pred, label=lbl))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    return dict(pred=pred, loss=loss)


def _feed():
    rng = np.random.RandomState(2)
    return dict(img=rng.rand(3, 1, 12, 12).astype(np.float32),
                lbl=rng.randint(0, 5, (3, 1)).astype(np.int64))


def _infer(fluid, exe, dirname, img):
    """Load a directory into a fresh scope and run its program."""
    with fluid.scope_guard(fluid.Scope()):
        prog, feeds, fetches = fluid.io.load_inference_model(dirname, exe)
        assert feeds == ["img"]
        return np.asarray(exe.run(prog, feed={"img": img},
                                  fetch_list=fetches)[0], np.float32)


def test_jax_saved_model_loads_in_the_port(tmp_path):
    pair = tp.FluidPair(_net)
    feed = _feed()
    pair.run(feed, ["loss"])  # running statistics move off their init
    d = str(tmp_path / "jax_model")
    with JF.scope_guard(pair.jscope):
        JF.io.save_inference_model(d, ["img"], [pair.jvars["pred"]],
                                   pair.jexe, main_program=pair.jmain)
    want = _infer(JF, pair.jexe, d, feed["img"])
    got = _infer(TF, TF.Executor(TF.CPUPlace()), d, feed["img"])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_port_saved_model_loads_in_jax(tmp_path):
    pair = tp.FluidPair(_net)
    feed = _feed()
    pair.run(feed, ["loss"])
    d = str(tmp_path / "port_model")
    with TF.scope_guard(pair.tscope):
        TF.io.save_inference_model(d, ["img"], [pair.tvars["pred"]],
                                   pair.texe, main_program=pair.tmain)
    want = _infer(TF, pair.texe, d, feed["img"])
    got = _infer(JF, JF.Executor(JF.CPUPlace()), d, feed["img"])
    np.testing.assert_allclose(got, want, atol=1e-5)
