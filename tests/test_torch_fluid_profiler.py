"""fluid.profiler in the port on the CPU: the per-op cost table of
`profiler()` against the JAX package's (the same rows and columns:
every forward op type with its call count, and the training run's
backward and update as one row), `trace_profile`'s reconciliation and
`compiled_profile`'s modelled table, and the small surface
(record_event, get_events, reset_profiler, device_memory_stats,
cuda_profiler, OpCounter). Times are host times here; the card's are
measured by chip_smoke.py."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
import paddle_tpu_torch.fluid as TF
from paddle_tpu_torch.fluid import profiler

torch.set_num_threads(2)

COLUMNS = {"Event", "Calls", "Total", "Min", "Max", "Ave"}


def _program(fluid, train=True):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data(name="x", shape=[2, 8, 8], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="int64")
        h = fluid.layers.conv2d(input=x, num_filters=4, filter_size=3,
                                act="relu")
        h = fluid.layers.pool2d(input=h, pool_size=2, pool_stride=2)
        pred = fluid.layers.fc(input=h, size=3, act="softmax")
        loss = fluid.layers.mean(x=fluid.layers.cross_entropy(
            input=pred, label=y))
        if train:
            fluid.optimizer.Momentum(learning_rate=0.1,
                                     momentum=0.9).minimize(loss)
    return main, startup, loss


def _feed():
    rng = np.random.RandomState(0)
    return {"x": rng.randn(4, 2, 8, 8).astype(np.float32),
            "y": rng.randint(0, 3, (4, 1)).astype(np.int64)}


def _profiled(fluid, place, train, runs=2):
    main, startup, loss = _program(fluid, train)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        exe = fluid.Executor(place)
        exe.run(startup)
        with fluid.profiler.profiler("All", sorted_key="calls"):
            for _ in range(runs):
                exe.run(main, feed=_feed(), fetch_list=[loss])
    return fluid.profiler.last_profile()


@pytest.mark.parametrize("train", [True, False])
def test_profiler_table_rows_equal_the_jax_packages(train, capsys):
    jrows = _profiled(JF, JF.CPUPlace(), train)
    trows = _profiled(TF, TF.CPUPlace(), train)
    out = capsys.readouterr().out
    assert "Profiling Report" in out and "Place: CPU" in out
    for r in trows:
        assert set(r) == COLUMNS
        assert r["Total"] >= 0 and r["Min"] <= r["Ave"] <= r["Max"]

    def calls(rows):
        return {r["Event"].replace(" (fused)", ""): r["Calls"]
                for r in rows}

    assert calls(trows) == calls(jrows)
    assert (profiler.BACKWARD_ROW in calls(trows)) == train
    # sorted by calls, as asked
    assert [r["Calls"] for r in trows] == sorted(
        (r["Calls"] for r in trows), reverse=True)


def test_profiler_keeps_training_semantics():
    """A run inside profiler() trains exactly as a run outside it."""
    states = []
    for profiled in (False, True):
        main, startup, loss = _program(TF)
        startup.random_seed = 3
        scope = TF.Scope()
        with TF.scope_guard(scope):
            exe = TF.Executor(TF.CPUPlace())
            exe.run(startup)
            if profiled:
                with profiler.profiler():
                    exe.run(main, feed=_feed(), fetch_list=[loss])
            else:
                exe.run(main, feed=_feed(), fetch_list=[loss])
        states.append([TF.as_numpy(scope.get(v.name)) for v in
                       main.global_block().vars.values() if v.persistable])
    for a, b in zip(*states):
        np.testing.assert_array_equal(a, b)


def test_profiler_rejects_bad_arguments():
    with pytest.raises(ValueError):
        with profiler.profiler(state="XPU"):
            pass
    with pytest.raises(ValueError):
        with profiler.profiler(sorted_key="median"):
            pass


def _exe_and_program():
    main, startup, loss = _program(TF)
    scope = TF.Scope()
    exe = TF.Executor(TF.CPUPlace())
    with TF.scope_guard(scope):
        exe.run(startup)
    return exe, main, loss, scope


def test_trace_profile_reconciles_on_the_cpu():
    exe, main, loss, scope = _exe_and_program()
    with TF.scope_guard(scope):
        table, meta = profiler.trace_profile(exe, main, _feed(), [loss],
                                             runs=2)
    assert set(meta) >= {"runs", "measured_total_ms", "unmatched_ms",
                         "top5_max_disagreement", "backend"}
    assert meta["backend"] == "cpu" and meta["runs"] == 2
    events = {r["Event"] for r in table}
    assert {"conv2d", "pool2d", "mul", profiler.BACKWARD_ROW} <= events
    for r in table:
        assert set(r) == {"Event", "measured_ms", "measured_share",
                          "modeled_share", "disagreement"}
    assert abs(sum(r["measured_share"] for r in table) - 1.0) < 1e-6
    assert abs(sum(r["modeled_share"] for r in table) - 1.0) < 1e-6
    assert 0.0 <= meta["top5_max_disagreement"] <= 1.0
    assert meta["measured_total_ms"] > 0
    # the rows hold the steps' time: what they miss is the executor's
    # own host work around the ops
    assert meta["matched_ms"] <= meta["measured_total_ms"] * 1.001


def test_compiled_profile_splits_the_step_by_traffic():
    exe, main, loss, scope = _exe_and_program()
    with TF.scope_guard(scope):
        table, meta = profiler.compiled_profile(exe, main, _feed(), [loss],
                                                runs=2)
    rows = {r["Event"]: r for r in table}
    assert COLUMNS | {"Bytes", "Flops"} <= set(rows["conv2d"])
    # conv: 2 * N * Cout * Hout * Wout * Cin * k * k
    assert rows["conv2d"]["Flops"] == 2 * 4 * 4 * 6 * 6 * 2 * 3 * 3
    assert rows[profiler.BACKWARD_ROW]["Bytes"] == 2 * sum(
        r["Bytes"] for e, r in rows.items() if e != profiler.BACKWARD_ROW)
    total = sum(r["Total"] for r in table)
    assert abs(total - meta["step_seconds"] * 1e3) < 1e-6 * max(total, 1)
    assert meta["timing_mode"] == "e2e" and meta["flops"] > 0


def test_events_memory_stats_and_the_cuda_profiler(capsys):
    profiler.reset_profiler()
    with profiler.record_event("load"):
        pass
    assert [n for n, _ in profiler.get_events()] == ["load"]
    profiler.reset_profiler()
    assert profiler.get_events() == [] and profiler.last_profile() == []
    if not torch.cuda.is_available():
        assert profiler.device_memory_stats() == {}
    assert profiler.device_memory_stats("cpu") == {}
    exe, main, loss, scope = _exe_and_program()
    with TF.scope_guard(scope):
        with profiler.cuda_profiler("unused.out"):
            exe.run(main, feed=_feed(), fetch_list=[loss])
    assert any(r["Event"] == "conv2d" for r in profiler.last_profile())
    assert profiler.active_op_collector() is None


def test_op_counter_counts_and_restores():
    from paddle_tpu_torch.fluid.core import registry

    exe, main, loss, scope = _exe_and_program()
    before = registry._KERNELS["conv2d"]
    with TF.scope_guard(scope):
        with profiler.OpCounter(["conv2d", "relu"], ranges=True) as c:
            exe.run(main, feed=_feed(), fetch_list=[loss])
            exe.run(main, feed=_feed(), fetch_list=[loss])
    assert c.counts == {"conv2d": 2, "relu": 2}
    assert registry._KERNELS["conv2d"] is before


def test_device_rows_attribute_kernels_to_the_nearest_range():
    """trace_profile's reading of a CUDA trace, on stand-in events: a
    kernel goes to the nearest fluid range around its launching op, a
    kernel under one of autograd's backward functions (on the engine's
    thread) to the backward row; a kernel under none stays unmatched,
    whichever thread launched it; the total is all kernel time, without
    the ranges' own spans on the device timeline."""
    import types

    from torch.autograd import DeviceType

    def ev(name, thread, parent=None, kernels=(), cuda_us=None):
        return types.SimpleNamespace(
            name=name, thread=thread, cpu_parent=parent,
            kernels=[types.SimpleNamespace(duration=d) for d in kernels],
            device_type=DeviceType.CUDA if cuda_us is not None
            else DeviceType.CPU, self_device_time_total=cuda_us or 0.0)

    step = ev("fluid/step", 1)
    conv = ev("fluid/op/conv2d", 1, step)
    opt = ev("fluid/optimizer", 1, step)
    bwd = ev("autograd::engine::evaluate_function: MulBackward0", 2)
    events = [step, conv, opt, bwd,
              ev("aten::cudnn_convolution", 1, conv, [300.0]),
              ev("aten::add_", 1, opt, [50.0]),
              ev("aten::mul", 2, bwd, [400.0]),        # engine thread
              ev("aten::fill_", 2, None, [10.0]),      # engine, no range
              ev("aten::copy_", 1, step, [25.0]),      # the feed upload
              ev("k", 0, cuda_us=785.0),
              # a range's span on the device timeline is no kernel
              ev("fluid/op/conv2d", 0, cuda_us=900.0)]
    prof = types.SimpleNamespace(events=lambda: events)
    rows, total = profiler._device_rows(prof)
    assert rows == {"conv2d": 0.3, profiler.BACKWARD_ROW: 0.45}
    assert total == 0.785
