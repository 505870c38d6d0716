"""memory_optimize in the port: the forward region runs as checkpointed
segments that the backward recomputes (core/lowering.py `_run_remat`),
held against the port's unmarked program and the JAX package's marked
one (jax.checkpoint) on the CPU.

Tolerances: on the CPU the recompute runs the same kernels on the same
inputs, so the port's marked and unmarked programs give equal losses
and parameters (bit for bit); against the JAX package, losses within
rtol 1e-5 (tests/test_memory_optimize.py's bar) in f32 and within 2e-2
under AMP (that test's AMP bar)."""

import contextlib
import io

import numpy as np
import pytest
import torch

import torch_parity as tp
from paddle_tpu_torch.fluid.core import kernels_control, lowering

torch.set_num_threads(2)
TF = tp.TF


def _mlp(fluid, _resnet=None, depth=2, dropout=False):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = x
    for _ in range(depth):
        h = fluid.layers.fc(input=h, size=16, act="tanh")
        if dropout:
            h = fluid.layers.dropout(h, dropout_prob=0.3)
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return dict(loss=loss)


def _feeds(steps=4, batch=16):
    rng = np.random.RandomState(3)
    return [{"x": rng.randn(batch, 8).astype(np.float32),
             "y": rng.randn(batch, 1).astype(np.float32)}
            for _ in range(steps)]


def _pair(build, remat, amp=False):
    pair = tp.FluidPair(build, amp=amp)
    pair.jmain.remat = pair.tmain.remat = remat
    return pair


def _train(pair, feeds):
    out = []
    for f in feeds:
        pair.texe._run_counter = pair.jexe._run_counter
        out.append(pair.run(f, ["loss"]))
    return ([float(j[0].reshape(-1)[0]) for j, _ in out],
            [float(t[0].reshape(-1)[0]) for _, t in out])


def test_memory_optimize_marks_the_program_and_its_clones():
    from paddle_tpu_torch.fluid import memory_optimization_transpiler as mot
    from paddle_tpu_torch.fluid.core import serialization

    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        _mlp(TF)
    assert not main.remat
    assert TF.memory_optimize(main) is main and main.remat
    assert mot.release_memory(main) is main
    assert main.clone(for_test=True).remat
    assert serialization.program_from_dict(
        serialization.program_to_dict(main)).remat


@pytest.mark.parametrize("amp", [False, True])
@pytest.mark.parametrize("dropout", [False, True])
def test_remat_matches_plain_and_the_jax_package(amp, dropout):
    def build(fluid, _r):
        return _mlp(fluid, depth=4, dropout=dropout)

    feeds = _feeds()
    plain = _pair(build, remat=False, amp=amp)
    _, t_plain = _train(plain, feeds)
    marked = _pair(build, remat=True, amp=amp)
    j_marked, t_marked = _train(marked, feeds)
    assert t_marked == t_plain
    # the two pairs' names differ (unique-name counters): pair by position
    for a, b in zip(plain.tmain.global_block().vars.values(),
                    marked.tmain.global_block().vars.values()):
        if a.persistable:
            np.testing.assert_array_equal(TF.as_numpy(marked.tscope.get(
                b.name)), TF.as_numpy(plain.tscope.get(a.name)))
    tol = dict(rtol=2e-2, atol=1e-2) if amp else dict(rtol=1e-5, atol=1e-6)
    assert np.all(np.isfinite(t_marked))
    np.testing.assert_allclose(t_marked, j_marked, **tol)


def test_remat_cuts_the_region_into_segments():
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        _mlp(TF, depth=12)
    ops = main.global_block().ops
    fwd = ops[:[o.type for o in ops].index("autodiff")]
    segs = lowering._remat_segments(fwd)
    assert len(segs) == round(len(fwd) ** 0.5) and \
        sum(len(s) for s in segs) == len(fwd)
    calls = []
    real = lowering.checkpoint

    def counting(fn, *a, **k):
        calls.append(fn)
        return real(fn, *a, **k)

    lowering.checkpoint = counting
    try:
        TF.memory_optimize(main)
        scope = TF.Scope()
        with TF.scope_guard(scope):
            exe = TF.Executor(TF.CPUPlace())
            exe.run(startup)
            exe.run(main, feed=_feeds(1)[0])
    finally:
        lowering.checkpoint = real
    assert len(calls) == len(segs)


def _bn_print_program(fluid):
    x = fluid.layers.data(name="x", shape=[2, 6, 6], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.conv2d(input=x, num_filters=3, filter_size=3)
    h = fluid.layers.batch_norm(input=h, act="relu")
    h = fluid.layers.Print(h, message="remat-probe", summarize=2)
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def _run_bn_print(remat):
    main, startup = TF.Program(), TF.Program()
    startup.random_seed = 1
    with TF.program_guard(main, startup):
        loss = _bn_print_program(TF)
    main.remat = remat
    rng = np.random.RandomState(0)
    feed = {"x": rng.randn(4, 2, 6, 6).astype(np.float32),
            "y": rng.randn(4, 1).astype(np.float32)}
    scope = TF.Scope()
    buf = io.StringIO()
    with TF.scope_guard(scope):
        exe = TF.Executor(TF.CPUPlace())
        exe.run(startup)
        with contextlib.redirect_stdout(buf):
            exe.run(main, feed=feed, fetch_list=[loss])
    bn = [op for op in main.global_block().ops if op.type == "batch_norm"][0]
    stats = [TF.as_numpy(scope.get(n))
             for n in bn.output("MeanOut") + bn.output("VarianceOut")]
    lines = [ln for ln in buf.getvalue().splitlines() if "remat-probe" in ln]
    return lines, stats


def test_no_side_effect_repeats_under_recompute():
    """A Print in the forward fires once per step (its gradient once),
    and the batch-norm running statistics move once, as without remat."""
    plain_lines, plain_stats = _run_bn_print(False)
    lines, stats = _run_bn_print(True)
    assert len(lines) == len(plain_lines) == 2  # forward value + gradient
    for a, b in zip(stats, plain_stats):
        np.testing.assert_array_equal(a, b)
    assert not np.allclose(plain_stats[0], 0.0)


def test_recompute_leaves_the_while_statistics_alone():
    ctx = lowering.LoweringContext(None, None, "cpu")
    ctx.recomputing = True
    before = dict(kernels_control.LAST_WHILE_STATS)
    kernels_control._stats(ctx, 99, 5, 5, True)
    assert kernels_control.LAST_WHILE_STATS == before


def test_remat_composes_with_sparse_gradients():
    def build(fluid, _r):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(input=ids, size=[50, 8],
                                     is_sparse=True)
        h = fluid.layers.fc(input=emb, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
        return dict(loss=loss)

    rng = np.random.RandomState(4)
    feeds = [{"ids": rng.randint(0, 50, (12, 1)).astype(np.int64),
              "y": rng.randn(12, 1).astype(np.float32)} for _ in range(3)]
    plain = _pair(build, remat=False)
    _, t_plain = _train(plain, feeds)
    marked = _pair(build, remat=True)
    j_marked, t_marked = _train(marked, feeds)
    assert t_marked == t_plain
    np.testing.assert_allclose(t_marked, j_marked, rtol=1e-5)


def test_recompute_keeps_the_amp_deny_list():
    """The backward recomputes a segment after the forward has left its
    AMP region: the deny-listed softmax and cross_entropy must compute
    in f32 there too (torch.utils.checkpoint checks what they save)."""
    def build(fluid, _r):
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = x
        for _ in range(6):
            h = fluid.layers.fc(input=h, size=16, act="relu")
        pred = fluid.layers.fc(input=h, size=4, act="softmax")
        loss = fluid.layers.mean(x=fluid.layers.cross_entropy(
            input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss)

    rng = np.random.RandomState(5)
    feeds = [{"x": rng.randn(16, 8).astype(np.float32),
              "y": rng.randint(0, 4, (16, 1)).astype(np.int64)}
             for _ in range(3)]
    _, plain = _train(_pair(build, remat=False, amp=True), feeds)
    j_marked, marked = _train(_pair(build, remat=True, amp=True), feeds)
    assert marked == plain
    np.testing.assert_allclose(marked, j_marked, rtol=2e-2, atol=1e-2)
