"""Executor.run_grad_accum in the port (core/lowering.py run_accum)
against the JAX package's (build_accum_step_fn) on the CPU, and against
the port's own full-batch step.

Tolerances: from the same JAX startup weights and batches, the losses
within rtol 1e-5 and the parameters (and batch-norm statistics) within
atol 1e-6 after 3 accumulated SGD steps; a K-chunk step against the
full-batch step within atol 1e-6 (the mean of chunk gradients equals
the batch gradient up to f32 summation order); dropout masks equal (the
same per-chunk keys)."""

import numpy as np
import pytest
import torch

import torch_parity as tp

torch.set_num_threads(2)
TF = tp.TF


def _model(fluid, _r=None, with_bn=False, dropout=False):
    x = fluid.layers.data(name="x", shape=[12], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=16, act="relu")
    if with_bn:
        h = fluid.layers.batch_norm(input=h)
    if dropout:
        h = fluid.layers.dropout(h, dropout_prob=0.25)
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return dict(loss=loss)


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 12).astype(np.float32),
            "y": rng.randn(n, 1).astype(np.float32)}


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("variant", ["plain", "batch_norm", "dropout"])
def test_accum_matches_the_jax_package(k, variant):
    pair = tp.FluidPair(lambda f, r: _model(
        f, with_bn=variant == "batch_norm", dropout=variant == "dropout"))
    for step in range(3):
        feed = _data(seed=step)
        with tp.JF.scope_guard(pair.jscope):
            (j,) = pair.jexe.run_grad_accum(
                pair.jmain, feed=feed, fetch_list=[pair.jvars["loss"]],
                micro_batches=k)
        pair.texe._run_counter = pair.jexe._run_counter - 1
        with TF.scope_guard(pair.tscope):
            (t,) = pair.texe.run_grad_accum(
                pair.tmain, feed=feed, fetch_list=[pair.tvars["loss"]],
                micro_batches=k)
        assert t.shape == np.asarray(j).shape == (1,)
        np.testing.assert_allclose(t, j, rtol=1e-5)
    for name, diff in pair.state_diff().items():
        assert diff <= 1e-6, (name, diff)


def _state(main, scope):
    """The persistables in declaration order (names differ per build)."""
    return [TF.as_numpy(scope.get(v.name))
            for v in main.global_block().vars.values() if v.persistable]


def _fresh(build=_model):
    main, startup = TF.Program(), TF.Program()
    startup.random_seed = 9
    with TF.program_guard(main, startup):
        loss = build(TF)["loss"]
    scope = TF.Scope()
    exe = TF.Executor(TF.CPUPlace())
    with TF.scope_guard(scope):
        exe.run(startup)
    return main, loss, scope, exe


def test_accum_step_equals_the_full_batch_step():
    results = {}
    for k in (1, 4):
        main, loss, scope, exe = _fresh()
        with TF.scope_guard(scope):
            losses = [float(exe.run_grad_accum(
                main, feed=_data(), fetch_list=[loss],
                micro_batches=k)[0][0]) for _ in range(3)]
        results[k] = (losses, _state(main, scope))
    main, loss, scope, exe = _fresh()
    with TF.scope_guard(scope):
        plain = [float(exe.run(main, feed=_data(), fetch_list=[loss])[0][0])
                 for _ in range(3)]
    np.testing.assert_allclose(results[1][0], plain, rtol=1e-6)
    np.testing.assert_allclose(results[4][0], plain, rtol=1e-5)
    for a, b, v in zip(results[4][1], results[1][1], _state(main, scope)):
        np.testing.assert_allclose(a, v, atol=1e-6)
        np.testing.assert_allclose(b, v, atol=1e-7)


def test_accum_refusals_match_the_jax_package():
    main, loss, scope, exe = _fresh()
    with TF.scope_guard(scope):
        with pytest.raises(ValueError, match="divisible"):
            exe.run_grad_accum(main, feed=_data(n=30), fetch_list=[loss],
                               micro_batches=4)
        with pytest.raises(ValueError, match=">= 1"):
            exe.run_grad_accum(main, feed=_data(), fetch_list=[loss],
                               micro_batches=0)
        feed = dict(_data(n=4))
        feed["x"] = (feed["x"], [[0, 2, 4]])
        with pytest.raises(NotImplementedError, match="LoD"):
            exe.run_grad_accum(main, feed=feed, fetch_list=[loss],
                               micro_batches=2)
        for flag in ("amp", "remat"):
            setattr(main, flag, True)
            with pytest.raises(NotImplementedError, match="amp/remat"):
                exe.run_grad_accum(main, feed=_data(), fetch_list=[loss])
            setattr(main, flag, False)
    infer = TF.Program()
    with TF.program_guard(infer, TF.Program()):
        x = TF.layers.data(name="x", shape=[4], dtype="float32")
        out = TF.layers.fc(input=x, size=2)
    with TF.scope_guard(TF.Scope()):
        exe = TF.Executor(TF.CPUPlace())
        with pytest.raises(ValueError, match="training program"):
            exe.run_grad_accum(infer, feed={
                "x": np.zeros((4, 4), np.float32)}, fetch_list=[out])


def test_accum_warns_on_a_sum_reduced_loss():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[12], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        cost = fluid.layers.square_error_cost(input=pred, label=y)
        loss = fluid.layers.reduce_sum(cost, dim=0, keep_dim=False)
        loss = fluid.layers.reshape(x=loss, shape=[1])
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss)

    main, loss, scope, exe = _fresh(build)
    with TF.scope_guard(scope):
        with pytest.warns(UserWarning, match="SUM reduction"):
            exe.run_grad_accum(main, feed=_data(n=8), fetch_list=[loss],
                               micro_batches=2)


def test_accum_fetch_of_a_chunk_intermediate_is_refused():
    main, loss, scope, exe = _fresh()
    hidden = [op for op in main.global_block().ops
              if op.type == "mul"][0].output("Out")[0]
    with TF.scope_guard(scope):
        with pytest.raises(KeyError, match="neither the loss"):
            exe.run_grad_accum(main, feed=_data(), fetch_list=[hidden],
                               micro_batches=2)
