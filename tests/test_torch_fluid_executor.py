"""The port's Fluid executor against the JAX package's on the CPU: the same
programs, built by each package's fluid API, train from the same JAX
startup weights (carried across with `scope_from_numpy`).

Tolerances: f32 losses within rtol 1e-4, and the model's state (params
and batch-norm running statistics) within atol 1e-4 after 3 steps
(reduction order only). Optimizer state (velocities, Adam moments) holds
raw gradient sums, whose reduction-order error the batch-norm variance
E[x^2] - E[x]^2 amplifies where a channel's mean is large against its
spread (after the first conv of a positive image and after ReLUs: ~5e-3
of the largest element at the first stage of resnet_cifar10, ~6e-6 past
it; the conv gradients alone agree to ~1e-6 on the same inputs), so it
is held within 1e-4 + 2e-2 of its largest magnitude. The bf16 AMP conv net's losses within rtol
2e-2 and its weights within atol 2e-2 (bf16 keeps ~3 significant digits
and the two packages' CPU convolutions accumulate in different orders);
uniform startup draws bit-identical."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import TF

torch.set_num_threads(2)

# bench.py's Momentum (the ResNet-50 headline's optimizer, bench.py:227)
# and Adam at its defaults
OPTIMIZERS = {
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.01,
                                               momentum=0.9),
    "adam": lambda f: f.optimizer.Adam(),
}


def fit_a_line(opt):
    """tests/test_fit_a_line.py's program."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1, act=None)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        test = fluid.default_main_program().clone(for_test=True)
        OPTIMIZERS[opt](fluid).minimize(loss)
        return dict(loss=loss, pred=pred, test_program=test)

    rng = np.random.RandomState(0)
    feed = dict(x=rng.uniform(-1, 1, (8, 13)).astype(np.float32),
                y=rng.uniform(-1, 1, (8, 1)).astype(np.float32))
    return build, feed, dict(x=feed["x"])


def _classifier(net, shape, classes=10):
    def make(opt):
        def build(fluid, resnet):
            img = fluid.layers.data(name="img", shape=shape,
                                    dtype="float32")
            lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
            pred = net(fluid, resnet, img, classes)
            loss = fluid.layers.mean(
                x=fluid.layers.cross_entropy(input=pred, label=lbl))
            acc = fluid.layers.accuracy(input=pred, label=lbl)
            test = fluid.default_main_program().clone(for_test=True)
            OPTIMIZERS[opt](fluid).minimize(loss)
            return dict(loss=loss, pred=pred, acc=acc, test_program=test)

        rng = np.random.RandomState(1)
        feed = dict(img=rng.rand(4, *shape).astype(np.float32),
                    lbl=rng.randint(0, classes, (4, 1)).astype(np.int64))
        return build, feed, dict(img=feed["img"])

    return make


def _mlp(fluid, resnet, img, classes):
    h = fluid.layers.fc(input=img, size=32, act="relu")
    return fluid.layers.fc(input=h, size=classes, act="softmax")


def _lenet(fluid, resnet, img, classes):
    c1 = fluid.layers.conv2d(input=img, num_filters=6, filter_size=5,
                             padding=2, act="relu")
    p1 = fluid.layers.pool2d(input=c1, pool_size=2, pool_stride=2)
    c2 = fluid.layers.conv2d(input=p1, num_filters=16, filter_size=5,
                             act="relu")
    p2 = fluid.layers.pool2d(input=c2, pool_size=2, pool_stride=2,
                             pool_type="avg")
    h = fluid.layers.fc(input=p2, size=32, act="relu")
    return fluid.layers.fc(input=h, size=classes, act="softmax")


def _resnet8(fluid, resnet, img, classes):
    return resnet.resnet_cifar10(img, class_dim=classes, depth=8)


MODELS = {
    "fit_a_line": fit_a_line,
    "mlp": _classifier(_mlp, [20]),
    "lenet": _classifier(_lenet, [1, 28, 28]),
    "resnet_cifar10_depth8": _classifier(_resnet8, [3, 32, 32]),
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
@pytest.mark.parametrize("model", sorted(MODELS))
def test_trains_like_the_jax_executor(model, opt):
    build, feed, test_feed = MODELS[model](opt)
    pair = tp.FluidPair(build)
    losses = [pair.run(feed, ["loss"]) for _ in range(3)]
    for j, t in losses:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    assert losses[-1][1][0] < losses[0][1][0]
    diff = pair.state_diff()
    model_state = pair.model_state_names()
    bad = sorted((d, n) for n, d in diff.items()
                 if n in model_state and d > 1e-4)
    assert not bad, bad[-3:]
    state = pair.jax_state()
    bad = sorted((d, n) for n, d in diff.items() if n not in model_state
                 and d > 1e-4 + 2e-2 * np.abs(state[n]).max())
    assert not bad, bad[-3:]
    # the for_test clone's forward, fed no labels: predictions only
    j, t = pair.run(test_feed, ["pred"], test=True)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4, atol=1e-5)


def test_bf16_amp_conv_net_tracks_the_jax_executor():
    build, feed, _ = MODELS["lenet"]("momentum")
    pair = tp.FluidPair(build, amp=True)
    for _ in range(3):
        j, t = pair.run(feed, ["loss"])
        np.testing.assert_allclose(t[0], j[0], rtol=2e-2)
    port = TF.scope_to_numpy(pair.tscope)
    for n, a in pair.jax_state().items():
        assert port[n].dtype == a.dtype, n  # master copies stay f32
        if "velocity" not in n:
            np.testing.assert_allclose(port[n], a, atol=2e-2, err_msg=n)


def test_fetch_in_the_training_step_and_accuracy():
    build, feed, _ = MODELS["mlp"]("momentum")
    pair = tp.FluidPair(build)
    j, t = pair.run(feed, ["loss", "acc", "pred"])
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6)


def test_startup_uniform_draws_are_bit_identical():
    """Xavier-uniform fc weights from the same random_seed: the port's
    threefry gives the JAX package's bits."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[13], dtype="float32")
        h = fluid.layers.fc(input=x, size=16,
                            param_attr=fluid.ParamAttr(
                                initializer=fluid.initializer.Uniform(
                                    -0.3, 0.7)))
        out = fluid.layers.fc(input=h, size=3)
        fluid.default_startup_program().random_seed = 7
        return dict(out=out)

    pair = tp.FluidPair(build)
    scope = TF.Scope()
    with TF.scope_guard(scope):
        TF.Executor(TF.CPUPlace()).run(pair.tstartup)
    port = TF.scope_to_numpy(scope)
    state = pair.jax_state()
    weights = [n for n in state if n.endswith(".w_0")]
    assert len(weights) == 2
    for n in weights:
        assert np.array_equal(port[n].view(np.int32),
                              state[n].view(np.int32)), n


def test_gaussian_startup_draws_match_within_ulps():
    """conv2d's Normal init: the same uniform bits through erfinv, which
    differs from XLA's by a few ulp (atol 1e-6 + rtol 1e-5)."""
    def build(fluid, resnet):
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        return dict(out=fluid.layers.conv2d(input=img, num_filters=8,
                                            filter_size=3))

    pair = tp.FluidPair(build)
    scope = TF.Scope()
    with TF.scope_guard(scope):
        TF.Executor(TF.CPUPlace()).run(pair.tstartup)
    port = TF.scope_to_numpy(scope)
    for n, a in pair.jax_state().items():
        np.testing.assert_allclose(port[n], a, rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_int64_labels_stay_int64_and_losses_agree():
    """The port keeps an int64 label feed as int64 (the JAX package
    narrows it to int32): the same losses either way."""
    build, feed, _ = MODELS["mlp"]("momentum")
    pair = tp.FluidPair(build)
    j, t = pair.run(feed, ["loss"])
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    with TF.scope_guard(pair.tscope):
        lbl, = pair.texe.run(pair.tmain, feed=feed, fetch_list=["lbl"],
                             return_numpy=False)
    assert lbl.dtype == torch.int64


def test_run_repeated_matches_single_runs():
    build, feed, _ = MODELS["mlp"]("adam")
    a, b = tp.FluidPair(build), tp.FluidPair(build)
    with TF.scope_guard(a.tscope):
        stacked = a.texe.run_repeated(a.tmain, feed=feed,
                                      fetch_list=[a.tvars["loss"]], steps=3)
    with TF.scope_guard(b.tscope):
        single = [b.texe.run(b.tmain, feed=feed,
                             fetch_list=[b.tvars["loss"]])[0]
                  for _ in range(3)]
    np.testing.assert_allclose(stacked[0][:, 0], np.ravel(single),
                               rtol=1e-6)


def test_executor_places():
    """No place means the card: it raises where there is none, and the
    CPU needs CPUPlace()."""
    assert TF.Executor(TF.CPUPlace()).device == torch.device("cpu")
    if torch.cuda.is_available():
        assert TF.Executor().device.type == "cuda"
        assert TF.Executor(TF.TPUPlace(0)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.Executor()
        with pytest.raises(RuntimeError, match="CUDA"):
            TF.Executor(TF.CUDAPlace(0))


def test_unported_ops_and_sparse_grads_raise():
    def build(fluid, resnet):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        emb = fluid.layers.embedding(input=ids, size=[10, 4],
                                     is_sparse=True)
        loss = fluid.layers.mean(x=emb)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss)

    pair = tp.FluidPair(build)
    feed = dict(ids=np.arange(4, dtype=np.int64).reshape(4, 1))
    with TF.scope_guard(pair.tscope):
        with pytest.raises(NotImplementedError, match="SelectedRows"):
            pair.texe.run(pair.tmain, feed=feed,
                          fetch_list=[pair.tvars["loss"]])
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        x = TF.layers.data(name="x", shape=[2, 4, 4], dtype="float32")
        y = TF.layers.lrn(input=x)
    with pytest.raises(NotImplementedError, match="'lrn'"):
        TF.Executor(TF.CPUPlace()).run(
            main, feed=dict(x=np.ones((1, 2, 4, 4), np.float32)),
            fetch_list=[y])


def test_nested_lod_feed_raises():
    """A 2-level LoD feed (nested sequences) was refused until control
    flow came; it now feeds as the JAX package feeds it: the finest
    level describes the rows (`x@LOD0`), the outer level rides
    `x@LOD_SRC`, so sequence ops pool the finest sequences."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=2)
        return dict(y=fluid.layers.sequence_pool(input=x, pool_type="sum"))

    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    feed = {"x": (data, [[0, 2, 3], [0, 1, 3, 5]])}
    pair = tp.FluidPair(build)
    (j,), (t,) = pair.run(feed, ["y"])
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(
        t, [data[0], data[1] + data[2], data[3] + data[4]])


def test_scope_arrays_are_never_shared_with_the_caller():
    """The CPU scope is updated in place: arrays loaded into it and
    arrays read out of it must be the caller's own copies."""
    build, feed, _ = MODELS["mlp"]("momentum")
    pair = tp.FluidPair(build)
    before = TF.scope_to_numpy(pair.tscope)
    loaded = {n: a.copy() for n, a in before.items()}
    scope = TF.scope_from_numpy(TF.Scope(), loaded, "cpu")
    with TF.scope_guard(scope):
        pair.texe.run(pair.tmain, feed=feed, fetch_list=[pair.tvars["loss"]])
    for n, a in before.items():
        np.testing.assert_array_equal(loaded[n], a, err_msg=n)
    after = TF.scope_to_numpy(scope)
    assert any(not np.array_equal(after[n], a) for n, a in before.items())
