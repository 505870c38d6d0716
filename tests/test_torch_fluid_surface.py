"""The port's executor surface against the JAX package on the CPU: the
program verifier's P-codes on the same malformed programs
(`verify_program`, `run(validate=True)`, PADDLE_TPU_VALIDATE on every
run entry point), the numerics guard's message, AsyncDeviceFeeder
(ordering, training equal to the synchronous feed, the source's
exceptions, `close()`), the small modules (debugger, op,
default_scope_funcs, net_drawer, graphviz) and `fluid.__all__`.

Tolerances: none needed — codes, messages, dot sources and op lists
compare equal; the feeder's training run equals the synchronous run bit
for bit (the same tensors reach the same kernels)."""

import threading

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
import paddle_tpu_torch.fluid as TF
from paddle_tpu.analysis import program_lint as jlint
from paddle_tpu_torch.analysis import ProgramVerifyError
from paddle_tpu_torch.analysis import program_lint as tlint
from paddle_tpu_torch.fluid.data_feeder import AsyncDeviceFeeder

torch.set_num_threads(2)


def _data_var(block, name, shape, dtype="float32"):
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True)


def _dangling(fluid):
    p = fluid.Program()
    b = p.global_block()
    _data_var(b, "x", (4,))
    b.create_var(name="out", shape=(4,), dtype="float32")
    b.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["ghost"]},
                outputs={"Out": ["out"]})
    return p, ["out"]


def _dead_write(fluid):
    p = fluid.Program()
    b = p.global_block()
    _data_var(b, "x", (4,))
    b.create_var(name="dead", shape=(4,), dtype="float32")
    b.create_var(name="live", shape=(4,), dtype="float32")
    b.append_op("square", inputs={"X": ["x"]}, outputs={"Out": ["dead"]})
    b.append_op("square", inputs={"X": ["x"]}, outputs={"Out": ["live"]})
    return p, ["live"]


def _binary(fluid, xs, ys, xd="float32", yd="float32"):
    p = fluid.Program()
    b = p.global_block()
    _data_var(b, "x", xs, xd)
    _data_var(b, "y", ys, yd)
    b.create_var(name="out", shape=xs, dtype="float32")
    b.append_op("elementwise_add", inputs={"X": ["x"], "Y": ["y"]},
                outputs={"Out": ["out"]})
    return p, ["out"]


def _duplicate_param(fluid):
    p = fluid.Program()
    b = p.global_block()
    b.create_parameter(name="w", shape=(2,), dtype="float32")
    b1 = p.create_block()
    b1.vars["w"] = fluid.Parameter(b1, shape=(2,), dtype="float32",
                                   name="w")
    return p, []


def _unpaired_grad(fluid):
    p = fluid.Program()
    b = p.global_block()
    _data_var(b, "x", (4,))
    b.create_var(name="phantom@GRAD", shape=(4,), dtype="float32")
    b.append_op("square", inputs={"X": ["x"]},
                outputs={"Out": ["phantom@GRAD"]})
    return p, ["phantom@GRAD"]


def _trained(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        h = fluid.layers.fc(input=x, size=8, act="relu")
        pred = fluid.layers.fc(input=h, size=1)
        loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return main, [loss.name]


PROGRAMS = {
    "P001_dangling_input": (_dangling, ["P001"]),
    "P002_dead_write": (_dead_write, ["P002"]),
    "P003_dtype_mismatch": (lambda f: _binary(f, (4,), (4,), yd="int32"),
                            ["P003"]),
    "P004_shape_mismatch": (lambda f: _binary(f, (4, 3), (4, 2)),
                            ["P004"]),
    "P004_broadcast_is_clean": (lambda f: _binary(f, (4, 3), (1, 3)), []),
    "P005_duplicate_parameter": (_duplicate_param, ["P005"]),
    "P006_unpaired_grad": (_unpaired_grad, ["P006"]),
    "clean_training_program": (_trained, []),
}


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_verifier_codes_equal_the_jax_packages(case):
    build, want = PROGRAMS[case]
    got = {}
    for side, fluid, lint in (("jax", JF, jlint), ("torch", TF, tlint)):
        p, fetches = build(fluid)
        got[side] = [(d.code, d.severity, d.detail, d.message)
                     for d in lint.verify_program(p, fetches=fetches)]
    assert [c[0] for c in got["torch"]] == want
    assert got["torch"] == got["jax"]


def _dynamic_rnn(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32",
                              lod_level=1)
        rnn = fluid.layers.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            mem = rnn.memory(shape=[4])
            h = fluid.layers.fc(input=[w, mem], size=4, act="tanh")
            rnn.update_memory(mem, h)
            rnn.output(h)
        out = fluid.layers.sequence_pool(rnn(), "sum")
        loss = fluid.layers.mean(x=out)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, [loss.name]


def _arrays(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        i = fluid.layers.fill_constant(shape=[1], dtype="int64", value=0)
        arr = fluid.layers.array_write(x, i)
        y = fluid.layers.array_read(arr, i)
    return main, [y.name]


@pytest.mark.parametrize("build", [_dynamic_rnn, _arrays],
                         ids=["dynamic_rnn", "tensor_array"])
def test_verifier_passes_control_flow_the_jax_copy_refuses(build):
    """A fault of the reference's verifier, fixed in the port's copy: it
    does not know the names a dynamic_rnn binds inside its sub-block, nor
    that create_array makes an array with no op, and reports P001 on
    these valid programs (which its executor runs)."""
    p, fetches = build(JF)
    assert "P001" in [d.code for d in jlint.verify_program(
        p, feeds=["x"], fetches=fetches)]
    p, fetches = build(TF)
    assert tlint.verify_program(p, feeds=["x"], fetches=fetches) == []


def test_run_validate_raises_the_p_code_before_any_op_runs():
    p, _ = _dangling(TF)
    exe = TF.Executor(TF.CPUPlace())
    with pytest.raises(ProgramVerifyError) as ei:
        exe.run(p, feed={"x": np.ones(4, np.float32)}, fetch_list=["out"],
                validate=True)
    assert "P001" in str(ei.value) and "ghost" in str(ei.value)
    assert [d.code for d in ei.value.diagnostics] == ["P001"]


def test_validate_env_covers_every_run_entry_point(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_VALIDATE", "1")
    p, _ = _dangling(TF)
    exe = TF.Executor(TF.CPUPlace())
    feed = {"x": np.ones(4, np.float32)}
    for call in (lambda: exe.run(p, feed=feed, fetch_list=["out"]),
                 lambda: exe.run_repeated(p, feed=feed, fetch_list=["out"],
                                          steps=2),
                 lambda: exe.run_grad_accum(p, feed=feed,
                                            fetch_list=["out"])):
        with pytest.raises(ProgramVerifyError):
            call()
    # a clean program passes, once per version and signature
    q = TF.Program()
    b = q.global_block()
    _data_var(b, "x", (4,))
    b.create_var(name="out", shape=(4,), dtype="float32")
    b.append_op("square", inputs={"X": ["x"]}, outputs={"Out": ["out"]})
    res = exe.run(q, feed={"x": 2 * np.ones(4, np.float32)},
                  fetch_list=["out"])
    assert np.allclose(res[0], 4.0)
    assert len(q._preflight_ok) == 1


def _mean_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        m = fluid.layers.mean(x=x)
    return main, m


def test_check_numerics_message_equals_the_jax_packages(monkeypatch):
    monkeypatch.setenv("PADDLE_TPU_CHECK_NUMERICS", "1")
    bad = {"x": np.array([[1.0, np.nan, np.inf, 3.0]], np.float32)}
    msgs = []
    for fluid, place in ((JF, JF.CPUPlace()), (TF, TF.CPUPlace())):
        main, m = _mean_program(fluid)
        exe = fluid.Executor(place)
        with pytest.raises(FloatingPointError) as ei:
            exe.run(main, feed=bad, fetch_list=[m, "x"])
        # the packages' unique-name counters differ within one process
        msgs.append(str(ei.value).replace(m.name, "<mean>"))
        ok = exe.run(main, feed={"x": np.ones((1, 4), np.float32)},
                     fetch_list=[m])
        assert np.allclose(ok[0], 1.0)
    assert msgs[1] == msgs[0]
    assert "fetch 'x' (2/4 non-finite)" in msgs[1]


def test_check_numerics_names_a_persistable_through_the_flag():
    from paddle_tpu_torch.utils import FLAGS

    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        x = TF.layers.data(name="x", shape=[2], dtype="float32")
        y = TF.layers.data(name="y", shape=[1], dtype="float32")
        pred = TF.layers.fc(input=x, size=1)
        loss = TF.layers.mean(x=TF.layers.square_error_cost(pred, y))
        TF.optimizer.SGD(learning_rate=0.1).minimize(loss)
    scope = TF.Scope()
    exe = TF.Executor(TF.CPUPlace())
    FLAGS.check_nan_inf = True
    try:
        with TF.scope_guard(scope):
            exe.run(startup)
            feed = {"x": np.ones((2, 2), np.float32),
                    "y": np.ones((2, 1), np.float32)}
            exe.run(main, feed=feed, fetch_list=[loss])
            feed["y"] = np.array([[np.inf], [1.0]], np.float32)
            with pytest.raises(FloatingPointError,
                               match="persistable 'fc_") as ei:
                exe.run(main, feed=feed, fetch_list=[loss])
            assert "fetch %r" % loss.name in str(ei.value)
    finally:
        FLAGS.check_nan_inf = False


# --- AsyncDeviceFeeder -----------------------------------------------------

def _feeder_program():
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        x = TF.layers.data(name="x", shape=[6], dtype="float32")
        y = TF.layers.data(name="y", shape=[1], dtype="float32")
        pred = TF.layers.fc(input=x, size=1, param_attr=TF.ParamAttr(
            name="adf_w", initializer=TF.initializer.Constant(0.2)))
        loss = TF.layers.mean(x=TF.layers.square_error_cost(pred, y))
        TF.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _batches(n=5):
    rng = np.random.RandomState(0)
    return [{"x": rng.rand(8, 6).astype(np.float32),
             "y": rng.rand(8, 1).astype(np.float32)} for _ in range(n)]


def _train(feeds):
    main, startup, loss = _feeder_program()
    scope = TF.Scope()
    with TF.scope_guard(scope):
        exe = TF.Executor(TF.CPUPlace())
        exe.run(startup)
        losses = [float(exe.run(main, feed=f, fetch_list=[loss])[0][0])
                  for f in feeds]
    return losses, TF.as_numpy(scope.get("adf_w"))


def test_async_feeder_keeps_order_and_trains_as_the_synchronous_feed():
    batches = _batches()
    fed = list(AsyncDeviceFeeder(iter(batches), capacity=2,
                                 place=TF.CPUPlace()))
    assert all(isinstance(f["x"], torch.Tensor) for f in fed)
    for f, b in zip(fed, batches):
        np.testing.assert_array_equal(f["x"].numpy(), b["x"])
    sync_losses, sync_w = _train(batches)
    async_losses, async_w = _train(fed)
    assert async_losses == sync_losses
    np.testing.assert_array_equal(async_w, sync_w)


def test_async_feeder_ragged_feeds_keep_offsets_on_the_host():
    data = np.arange(10, dtype=np.int64).reshape(5, 2)
    feed = {"w": (data, [[0, 2, 5]])}
    (out,) = list(AsyncDeviceFeeder(iter([feed]), place=TF.CPUPlace()))
    t, lod = out["w"]
    assert isinstance(t, torch.Tensor) and lod == [[0, 2, 5]]
    (host,) = list(AsyncDeviceFeeder(iter([feed]), upload=False))
    assert host["w"][0] is data


def test_async_feeder_reraises_the_source_exception():
    batches = _batches(1)

    def bad_iter():
        yield batches[0]
        raise ValueError("boom in the reader")

    feeder = AsyncDeviceFeeder(bad_iter(), place=TF.CPUPlace())
    next(feeder)
    with pytest.raises(ValueError, match="boom in the reader"):
        next(feeder)
    with pytest.raises(StopIteration):
        next(feeder)


def test_async_feeder_close_releases_a_blocked_producer():
    batches = _batches(1)
    produced = threading.Event()

    def endless():
        while True:
            produced.set()
            yield batches[0]

    feeder = AsyncDeviceFeeder(endless(), capacity=1, place=TF.CPUPlace())
    next(feeder)
    assert produced.wait(5)
    feeder.close()
    assert not feeder._thread.is_alive()
    with pytest.raises(StopIteration):
        next(feeder)


def test_async_feeder_uploads_to_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("the refusal needs a machine without a card")
    with pytest.raises(RuntimeError):
        AsyncDeviceFeeder(iter([]))


# --- the small modules and the package surface -----------------------------

def _small_program(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        h = fluid.layers.fc(input=x, size=2, act="relu")
        fluid.layers.mean(x=h)
    return main, startup


def test_debugger_dumps_equal_the_jax_packages():
    from paddle_tpu.fluid import debuger as jdbg, net_drawer as jnd
    from paddle_tpu_torch.fluid import debuger as tdbg, graphviz, \
        net_drawer as tnd

    jm, js = _small_program(JF)
    tm, ts = _small_program(TF)
    strip = lambda s: s.replace(" ", "")  # noqa: E731
    assert strip(tdbg.program_to_code(tm)).count("\n") == \
        strip(jdbg.program_to_code(jm)).count("\n")
    assert [ln.split("(")[0].split("=")[-1] for ln in
            tdbg.program_to_code(tm).splitlines() if "(" in ln] == \
        [ln.split("(")[0].split("=")[-1] for ln in
         jdbg.program_to_code(jm).splitlines() if "(" in ln]
    dot = tnd.draw_graph(ts, tm)
    assert dot.count("->") == jnd.draw_graph(js, jm).count("->")
    assert graphviz.draw_block_graphviz is TF.debugger.draw_block_graphviz


def test_op_factory_over_the_ports_registry():
    from paddle_tpu_torch.fluid import op

    assert op.get_all_op_protos() == sorted(op.get_all_op_protos())
    assert len(op.get_all_op_protos()) == 210
    p = TF.Program()
    b = p.global_block()
    b.create_var(name="x", shape=(3,), dtype="float32")
    op.Operator("scale", X=["x"], Out=["y"], scale=2.0).append_to(b)
    (y,) = TF.Executor(TF.CPUPlace()).run(
        p, feed={"x": np.arange(3, dtype=np.float32)}, fetch_list=["y"])
    np.testing.assert_array_equal(y, [0.0, 2.0, 4.0])
    with pytest.raises(ValueError, match="no kernel"):
        op.Operator("no_such_op")


def test_default_scope_funcs():
    from paddle_tpu_torch.fluid import default_scope_funcs as dsf

    assert dsf.get_cur_scope() is TF.global_scope()
    dsf.enter_local_scope()
    try:
        dsf.var("tmp_v").get_tensor().set(np.ones(2, np.float32))
        assert dsf.find_var("tmp_v") is not None
    finally:
        dsf.leave_local_scope()
    assert dsf.find_var("tmp_v") is None
    with pytest.raises(RuntimeError):
        dsf.leave_local_scope()
    assert dsf.scoped_function(lambda: dsf.get_cur_scope()) is not \
        TF.global_scope()


def test_fluid_all_covers_the_jax_packages():
    assert set(JF.__all__) <= set(TF.__all__)
    for name in JF.__all__:
        assert hasattr(TF, name), name
    missing = {n for n in dir(JF) if not n.startswith("_")
               and not hasattr(TF, n)}
    # the mesh executor and the transpiler are ported too: nothing left
    assert missing == set()


def test_only_the_mesh_refuses():
    """What still refuses is about the mesh, and says so: local SGD
    without a mesh, gradient accumulation on one (as in the JAX
    package); the mesh executor itself takes a mesh."""
    exe = TF.Executor(TF.CPUPlace())
    with pytest.raises(ValueError, match="mesh with a 'data' axis"):
        exe.run_async_local()
    mesh_exe = TF.Executor(TF.CPUPlace(), mesh=object())
    assert mesh_exe.mesh is not None
    with pytest.raises(NotImplementedError, match="on a mesh"):
        mesh_exe.run_grad_accum()
