"""fluid.optimizer.StaticPruning in the port against the JAX package on the
CPU: the Fluid half of tests/test_static_pruning.py (the v2-trainer
halves belong to the legacy stack, not ported yet).

Tolerances: the startup programs draw the same weights (the ported
threefry) and build the same mask (equal, element for element); after
10 Momentum steps from the JAX startup's scope the parameters agree
within atol 1e-6 and the pruned entries are exactly zero in both."""

import numpy as np
import pytest
import torch

import torch_parity as tp

torch.set_num_threads(2)


def _sparsity(arr):
    return float((np.asarray(arr) == 0.0).mean())


def _pruned_fc(fluid, size_in=16, size=1, ratio=0.75, name="w_pruned",
               init=None, with_average=False):
    x = fluid.layers.data(name="x", shape=[size_in], dtype="float32")
    y = fluid.layers.data(name="y", shape=[size], dtype="float32")
    pred = fluid.layers.fc(input=x, size=size, bias_attr=False,
                           param_attr=fluid.ParamAttr(name=name,
                                                      initializer=init))
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.Momentum(learning_rate=0.05, momentum=0.9).minimize(loss)
    main = fluid.default_main_program()
    pr = fluid.optimizer.StaticPruning(sparsity_ratio=ratio).build(
        main, fluid.default_startup_program(),
        targets=[p for p in main.global_block().all_parameters()
                 if p.name == name])
    out = dict(loss=loss, pruning=pr)
    if with_average:
        out["ma"] = fluid.optimizer.ModelAverage(
            average_window=0.15, min_average_window=2).build()
    return out


def _startup(fluid, main, startup):
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        place = fluid.CPUPlace()
        fluid.Executor(place).run(startup)
    return scope


def test_startup_mask_equals_the_jax_packages():
    sides = {}
    for side, fluid in (("jax", tp.JF), ("torch", tp.TF)):
        main, startup = fluid.Program(), fluid.Program()
        startup.random_seed = 5
        with fluid.program_guard(main, startup):
            pr = _pruned_fc(fluid, size_in=32, size=4, ratio=0.6)["pruning"]
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
        sides[side] = (pr, scope)
    (jpr, js), (tpr, ts) = sides["jax"], sides["torch"]
    assert tpr.masks == jpr.masks == {"w_pruned": "w_pruned@PRUNE_MASK"}
    jm = np.asarray(js.get("w_pruned@PRUNE_MASK"))
    tm = tp.TF.as_numpy(ts.get("w_pruned@PRUNE_MASK"))
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(tp.TF.as_numpy(ts.get("w_pruned")),
                                  np.asarray(js.get("w_pruned")))
    assert _sparsity(tm) == 1.0 - round(128 * 0.4) / 128


@pytest.mark.parametrize("with_average", [False, True])
def test_training_keeps_the_pruned_entries_zero(with_average):
    pair = tp.FluidPair(lambda fluid, _r: _pruned_fc(
        fluid, with_average=with_average))
    w0 = tp.TF.as_numpy(pair.tscope.get("w_pruned"))
    zeros = w0 == 0.0
    assert abs(_sparsity(w0) - 0.75) < 0.1
    rng = np.random.RandomState(0)
    for _ in range(10):
        j, t = pair.run({"x": rng.randn(8, 16).astype(np.float32),
                         "y": rng.randn(8, 1).astype(np.float32)}, ["loss"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
    w = tp.TF.as_numpy(pair.tscope.get("w_pruned"))
    assert (w[zeros] == 0.0).all()
    assert not np.allclose(w[~zeros], w0[~zeros])
    np.testing.assert_allclose(w, np.asarray(pair.jscope.get("w_pruned")),
                               atol=1e-6)
    if with_average:
        # pruning precedes the accumulation: the average is sparse too
        with pair.tvars["ma"].apply(scope=pair.tscope):
            avg = tp.TF.as_numpy(pair.tscope.get("w_pruned"))
        assert (avg[zeros] == 0.0).all()
        assert not np.allclose(avg, w)


def test_tied_magnitudes_prune_an_exact_fraction():
    fluid = tp.TF
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _pruned_fc(fluid, size_in=8, size=4, ratio=0.5, name="w_const",
                   init=fluid.initializer.Constant(0.5))
    w = tp.TF.as_numpy(_startup(fluid, main, startup).get("w_const"))
    assert _sparsity(w) == 0.5
    # stable top-k: the first half of the flat weights survive
    np.testing.assert_array_equal(w.reshape(-1)[:16], 0.5)


def test_recompute_masks_from_loaded_weights():
    fluid = tp.TF
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[10], dtype="float32")
        fluid.layers.fc(input=x, size=1, bias_attr=False,
                        param_attr=fluid.ParamAttr(name="w_load"))
        pr = fluid.optimizer.StaticPruning(sparsity_ratio=0.7).build(
            main, startup, targets=[
                p for p in main.global_block().all_parameters()
                if p.name == "w_load"])
    scope = fluid.Scope()
    w = np.arange(1, 11, dtype=np.float32).reshape(10, 1)
    scope.set("w_load", torch.from_numpy(w.copy()))
    pr.recompute(scope)
    got = tp.TF.as_numpy(scope.get("w_load"))
    assert (got[:7] == 0).all() and (got[7:] == w[7:]).all()


def test_hook_ratio_default_and_range():
    from paddle_tpu_torch.fluid.optimizer import StaticPruning

    class Hook:
        type = "pruning"
        sparsity_ratio = None

    class P:
        update_hook = Hook()

    assert StaticPruning._hook_ratio(P()) == StaticPruning.DEFAULT_RATIO
    fluid = tp.TF
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with pytest.raises(ValueError, match="sparsity_ratio"):
            _pruned_fc(fluid, ratio=1.0)
