"""fluid.optimizer.ModelAverage in the port against the JAX package on the
CPU: the Fluid half of tests/test_model_average.py (the v2-trainer and
CLI halves belong to the legacy stack, not ported yet).

The same program is built with each package and trained from the JAX
startup's weights on the same seeded batches. Tolerances: parameters
and the window sums within atol 1e-6 after 60 SGD steps (f32 rounding
of the same updates), the counters equal, `apply()`'s averaged weights
within 1e-6 of the JAX package's and within rtol 1e-4 of the numpy
oracle of AverageOptimizer.cpp, `restore` bit for bit."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_model_average import _oracle_average

torch.set_num_threads(2)


def _build(rate=0.25, min_w=5, max_w=10000):
    def build(fluid, _resnet):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ma = fluid.optimizer.ModelAverage(
            average_window=rate, min_average_window=min_w,
            max_average_window=max_w).build()
        return dict(loss=loss, ma=ma)
    return tp.FluidPair(build)


@pytest.mark.parametrize("rate,min_w,max_w,steps", [
    (0.25, 5, 10000, 60),   # several window shifts, the sum_3 path
    (1.0, 1, 10 ** 9, 30),  # a shift every step
])
def test_average_matches_the_jax_package_and_the_oracle(rate, min_w, max_w,
                                                        steps):
    pair = _build(rate, min_w, max_w)
    rng = np.random.RandomState(0)
    W = rng.randn(4, 1).astype(np.float32)
    w_t = pair.tmain.global_block().all_parameters()[0].name
    history = []
    for _ in range(steps):
        xv = rng.randn(16, 4).astype(np.float32)
        pair.run({"x": xv, "y": (xv @ W).astype(np.float32)}, ["loss"])
        history.append(tp.TF.as_numpy(pair.tscope.get(w_t)))
    port = tp.TF.scope_to_numpy(pair.tscope)
    for jname, a in pair.jax_state().items():
        b = port[jname]
        if a.dtype.kind in "iu":
            np.testing.assert_array_equal(b, a, err_msg=jname)
        else:
            np.testing.assert_allclose(b, a, atol=1e-6, err_msg=jname)
    jma, tma = pair.jvars["ma"], pair.tvars["ma"]
    assert [pair.names[n] for n in jma._param_names] == tma._param_names
    live = pair.tscope.get(w_t)
    with tma.apply(scope=pair.tscope):
        t_applied = tp.TF.as_numpy(pair.tscope.get(w_t))
    assert pair.tscope.get(w_t) is live  # restore puts the tensor back
    w_j = {v: k for k, v in pair.names.items()}[w_t]
    with jma.apply(scope=pair.jscope):
        j_applied = np.asarray(pair.jscope.get(w_j))
    np.testing.assert_allclose(t_applied, j_applied, atol=1e-6)
    np.testing.assert_allclose(
        t_applied, _oracle_average(history, rate, min_w, max_w), rtol=1e-4,
        atol=1e-5)
    assert not np.allclose(t_applied, tp.TF.as_numpy(live))


def test_apply_without_restore_keeps_the_average():
    pair = _build()
    rng = np.random.RandomState(1)
    for _ in range(8):
        pair.run({"x": rng.randn(8, 4).astype(np.float32),
                  "y": rng.randn(8, 1).astype(np.float32)}, ["loss"])
    w = pair.tmain.global_block().all_parameters()[0].name
    with pair.tvars["ma"].apply(scope=pair.tscope):
        avg = tp.TF.as_numpy(pair.tscope.get(w))
    with pair.tvars["ma"].apply(scope=pair.tscope, need_restore=False):
        pass
    np.testing.assert_array_equal(tp.TF.as_numpy(pair.tscope.get(w)), avg)


def test_opt_out_premature_apply_and_guard():
    fluid = tp.TF
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=3, param_attr=fluid.ParamAttr(
            do_model_average=False))
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        ma = fluid.optimizer.ModelAverage(average_window=200).build(main)
    opted_out = [p.name for p in main.global_block().all_parameters()
                 if getattr(p, "do_model_average", None) is False]
    assert opted_out and all(n not in ma._param_names for n in opted_out)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
        with pytest.raises(RuntimeError, match="before any training"):
            with ma.apply(scope=scope):
                pass
    with pytest.raises(ValueError, match="program_guard"):
        fluid.optimizer.ModelAverage().build(main)


def test_attach_adopts_the_slots_of_a_scope():
    pair = _build()
    rng = np.random.RandomState(2)
    for _ in range(6):
        pair.run({"x": rng.randn(8, 4).astype(np.float32),
                  "y": rng.randn(8, 1).astype(np.float32)}, ["loss"])
    fresh = tp.TF.optimizer.ModelAverage().attach(pair.tscope)
    assert fresh._param_names == sorted(pair.tvars["ma"]._param_names)
    assert fresh._steps_name == pair.tvars["ma"]._steps_name
