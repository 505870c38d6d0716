"""The port's mesh executor beyond dense data parallelism, against the
JAX package: the row-sharded SelectedRows table
(tests/test_selected_rows.py:395), local SGD and its guards
(tests/test_async_local.py:53-158), the distribute transpiler with the
ListenAndServ / Send shims (tests/test_distributed_services.py:365), a
ragged LSTM over two ranks (tests/test_multihost.py:225, without its
checkpoint), the gradient's scale over two ranks, and the refusal of a
batch-axis op with no global form. Ranks are CPU processes in one gloo
group (tests/torch_mesh.py); jax stays in the pytest process."""

import warnings

import numpy as np
import pytest

from torch_mesh import load_snapshot, snapshot, spawn




# --- the row-sharded sparse table ----------------------------------------

def emb_net(fluid, shard):
    ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    emb = fluid.layers.embedding(
        input=ids, size=[256, 16], is_sparse=True,
        param_attr=fluid.ParamAttr(
            name="shard_emb",
            initializer=fluid.initializer.Normal(scale=0.1, seed=61)))
    pred = fluid.layers.fc(
        input=emb, size=1,
        param_attr=fluid.ParamAttr(
            name="shard_fc", initializer=fluid.initializer.Constant(0.3)))
    cost = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    if shard is not None:
        shard(fluid.default_main_program().global_block().var("shard_emb"))
    fluid.optimizer.SGD(learning_rate=0.2).minimize(cost)
    return cost


def emb_batches():
    rng = np.random.RandomState(1)
    return [(rng.randint(0, 256, (16, 1)).astype(np.int64),
             rng.rand(16, 1).astype(np.float32)) for _ in range(3)]


def _sparse_worker(rank, world, snap):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.parallel.mesh import P

    out = {}
    for key, axes, spec in (
            ("rows", {"data": 2, "model": 2}, P("model", None)),
            ("replicated", {"data": 4}, None)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(fluid.Scope()):
            cost = emb_net(fluid, None if spec is None else (
                lambda v: parallel.shard_parameter(v, spec)))
            mesh = parallel.make_mesh(axes, device="cpu")
            exe = fluid.Executor(mesh=mesh)
            load_snapshot(fluid, main, fluid.global_scope(), snap)
            exe._run_counter = 1
            n, i = mesh.extent("data"), mesh.index("data")
            for ids, y in emb_batches():
                b = ids.shape[0] // n
                exe.run(main, feed={"ids": ids[i * b:(i + 1) * b],
                                    "y": y[i * b:(i + 1) * b]},
                        fetch_list=[cost])
            out[key] = dict(
                w=fluid.fetch_var("shard_emb"),
                here=tuple(fluid.global_scope().get("shard_emb").shape))
    return out


def test_row_sharded_sparse_table_matches_the_jax_mesh(tmp_path):
    import jax.sharding
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    def jax_train(mesh, shard):
        main, startup = JF.Program(), JF.Program()
        with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
            cost = emb_net(JF, shard)
            exe = JF.Executor(mesh=mesh)
            exe.run(startup)
            snap = snapshot(main, JF.global_scope().get)
            for ids, y in emb_batches():
                exe.run(main, feed={"ids": ids, "y": y}, fetch_list=[cost])
            return np.asarray(JF.global_scope().get("shard_emb")), snap

    w_ref, snap = jax_train(None, None)
    w_mesh, _ = jax_train(jp.make_mesh({"data": 4, "model": 2}),
                          lambda v: jp.shard_parameter(
                              v, jax.sharding.PartitionSpec("model", None)))
    outs = spawn(_sparse_worker, 4, tmp_path, snap)
    for o in outs:
        assert o["rows"]["here"] == (128, 16)  # half the rows a rank
        assert o["replicated"]["here"] == (256, 16)
        for key in ("rows", "replicated"):
            np.testing.assert_allclose(o[key]["w"], w_ref, rtol=0,
                                       atol=2e-5)
            np.testing.assert_allclose(o[key]["w"], w_mesh, rtol=0,
                                       atol=2e-5)


# --- local SGD -------------------------------------------------------------

STEPS, BATCH, DIM = 8, 32, 6


def async_data(seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(STEPS, BATCH, DIM).astype(np.float32)
    w = rng.rand(DIM, 1).astype(np.float32)
    y = (x @ w + 0.1 * rng.rand(STEPS, BATCH, 1)).astype(np.float32)
    return x, y


def async_net(fluid, momentum=None):
    x = fluid.layers.data(name="x", shape=[DIM], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(
        input=x, size=1,
        param_attr=fluid.ParamAttr(
            name="w", initializer=fluid.initializer.Constant(0.25)),
        bias_attr=fluid.ParamAttr(
            name="b", initializer=fluid.initializer.Constant(0.0)))
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    if momentum is None:
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    else:
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=momentum).minimize(loss)
    return loss


def _async_worker(rank, world, x, y):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.parallel.mesh import P

    mesh = parallel.make_mesh({"data": world}, device="cpu")
    b = BATCH // world
    xs, ys = x[:, rank * b:(rank + 1) * b], y[:, rank * b:(rank + 1) * b]
    out = {}
    for key, momentum, every in (("sync1", 0.9, 1), ("local4", None, 4)):
        with fluid.program_guard(fluid.Program(), fluid.Program()), \
                fluid.scope_guard(fluid.Scope()):
            loss = async_net(fluid, momentum)
            exe = fluid.Executor(mesh=mesh)
            exe.run(fluid.default_startup_program())
            losses = exe.run_async_local(
                feed={"x": xs, "y": ys}, fetch_list=[loss], steps=STEPS,
                sync_every=every)[0].ravel()
            out[key] = dict(losses=losses, w=fluid.fetch_var("w"),
                            b=fluid.fetch_var("b"))
    # the synchronous executor on the same mesh: run_repeated
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        loss = async_net(fluid, 0.9)
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        losses = exe.run_repeated(feed={"x": xs, "y": ys},
                                  fetch_list=[loss], steps=STEPS,
                                  scan_feeds=True)[0].ravel()
        out["sync"] = dict(losses=losses, w=fluid.fetch_var("w"))
        errors = []
        try:
            exe.run_async_local(feed={"x": xs, "y": ys}, fetch_list=[loss],
                                steps=5, sync_every=2)
        except ValueError as e:
            errors.append(str(e))
        main = fluid.default_main_program()
        parallel.shard_parameter(main.global_block().var("w"), P("data"))
        try:
            exe.run_async_local(feed={"x": xs, "y": ys}, fetch_list=[loss],
                                steps=4, sync_every=2)
        except ValueError as e:
            errors.append(str(e))
        try:
            exe.run_grad_accum(feed={"x": xs[0], "y": ys[0]},
                               fetch_list=[loss])
        except NotImplementedError as e:
            errors.append(str(e))
        out["errors"] = errors
    return out


def test_local_sgd_matches_the_jax_runner(tmp_path):
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    x, y = async_data(0)
    mesh = jp.make_mesh({"data": 4})
    ref = {}
    for key, momentum, every in (("sync1", 0.9, 1), ("local4", None, 4)):
        with JF.program_guard(JF.Program(), JF.Program()), \
                JF.scope_guard(JF.Scope()):
            loss = async_net(JF, momentum)
            exe = JF.Executor(mesh=mesh)
            exe.run(JF.default_startup_program())
            losses = exe.run_async_local(
                feed={"x": x, "y": y}, fetch_list=[loss], steps=STEPS,
                sync_every=every)[0].ravel()
            ref[key] = dict(losses=losses,
                            w=np.asarray(JF.global_scope().get("w")),
                            b=np.asarray(JF.global_scope().get("b")))
    outs = spawn(_async_worker, 4, tmp_path, x, y)
    for o in outs:
        for key in ("sync1", "local4"):
            np.testing.assert_allclose(o[key]["losses"], ref[key]["losses"],
                                       rtol=2e-5)
            for p in ("w", "b"):
                np.testing.assert_allclose(o[key][p], ref[key][p],
                                           rtol=3e-5, atol=1e-6)
        # sync_every=1 is the synchronous all-reduce step
        np.testing.assert_allclose(o["sync1"]["losses"], o["sync"]["losses"],
                                   rtol=2e-5)
        np.testing.assert_allclose(o["sync1"]["w"], o["sync"]["w"],
                                   rtol=2e-5, atol=1e-7)
        assert "multiple of sync_every" in o["errors"][0]
        assert "data parallelism only" in o["errors"][1]
        assert "run_grad_accum is single-chip" in o["errors"][2]


def test_local_sgd_needs_a_data_mesh():
    from paddle_tpu_torch import fluid

    x, y = async_data(2)
    loss = async_net(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(fluid.default_startup_program())
    with pytest.raises(ValueError, match="mesh with a 'data' axis"):
        exe.run_async_local(feed={"x": x, "y": y}, fetch_list=[loss],
                            steps=4, sync_every=2)


# --- transpiler, pserver shims, gradient scale, refusals ------------------

def served_net(fluid):
    """fc regression whose SGD runs in a ListenAndServ optimize block."""
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(
        input=x, size=1,
        param_attr=fluid.ParamAttr(
            name="w_serv", initializer=fluid.initializer.Constant(0.2)))
    cost = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    params_grads = fluid.backward.append_backward(cost)
    serv = fluid.layers.ListenAndServ("127.0.0.1:0", fan_in=1)
    with serv.do():
        block = fluid.default_main_program().current_block()
        lr = block.create_var(name="lr_const", shape=[1], dtype="float32",
                              persistable=True)
        block.append_op(type="fill_constant", inputs={},
                        outputs={"Out": [lr]},
                        attrs={"shape": [1], "value": 0.1,
                               "dtype": "float32"})
        for p, g in params_grads:
            block.append_op(type="sgd",
                            inputs={"Param": [p], "Grad": [g],
                                    "LearningRate": [lr]},
                            outputs={"ParamOut": [p]})
    sent = fluid.layers.Send("127.0.0.1:0", [p for p, _ in params_grads],
                             [p for p, _ in params_grads])
    assert sent == [p for p, _ in params_grads]
    return cost, serv, params_grads


def served_batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(8, 4).astype(np.float32),
             rng.randn(8, 1).astype(np.float32)) for _ in range(3)]


def _transpiler_worker(rank, world):
    from paddle_tpu_torch import fluid, parallel

    out = {}
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(
            input=x, size=1,
            param_attr=fluid.ParamAttr(
                name="t_w", initializer=fluid.initializer.Constant(0.1)))
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        t = fluid.DistributeTranspiler()
        t.transpile(trainer_id=rank,
                    pservers="127.0.0.1:6174,127.0.0.1:6175",
                    trainers=world, device="cpu")
        parallel.set_default_mesh(None)
        prog = t.get_trainer_program()
        mesh = parallel.get_default_mesh()
        out["same_program"] = prog is fluid.default_main_program()
        out["mesh"] = dict(mesh.shape)
        fluid.Executor(fluid.CPUPlace()).run(
            t.get_pserver_program("127.0.0.1:6174"))
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        rng = np.random.RandomState(0)
        xd = rng.randn(16, 4).astype(np.float32)
        yd = xd.sum(axis=1, keepdims=True).astype(np.float32)
        xs, ys = xd[rank * 8:(rank + 1) * 8], yd[rank * 8:(rank + 1) * 8]
        runs = [exe.run(prog, feed={"x": xs, "y": ys},
                        fetch_list=[loss, "t_w@GRAD"]) for _ in range(2)]
        out["losses"] = [float(r[0][0]) for r in runs]
        out["grad"] = runs[0][1]
        out["places"] = len(fluid.layers.get_places())
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t2 = fluid.DistributeTranspiler()
            t2.transpile(trainer_id=rank, trainers=world, sync_mode=False,
                         device="cpu")
            t2.get_trainer_program()
        out["async_warned"] = sum("run_async_local" in str(w.message)
                                  for w in caught)
        parallel.set_default_mesh(None)

    # the served optimize block runs on the summed gradients
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        cost, serv, _ = served_net(fluid)
        mesh = parallel.make_mesh({"data": world}, device="cpu")
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        for xb, yb in served_batches():
            exe.run(feed={"x": xb[rank * 4:(rank + 1) * 4],
                          "y": yb[rank * 4:(rank + 1) * 4]},
                    fetch_list=[cost])
        out["served"] = fluid.fetch_var("w_serv")

    # a batch-axis op with no global form refuses, naming itself
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        both = fluid.layers.concat([x, x], axis=0)
        total = fluid.layers.reduce_sum(both)
        exe = fluid.Executor(mesh=parallel.make_mesh({"data": world},
                                                     device="cpu"))
        try:
            exe.run(feed={"x": np.ones((4, 4), np.float32)},
                    fetch_list=[total])
            out["refused"] = None
        except NotImplementedError as e:
            out["refused"] = str(e)
    return out


def test_transpiler_pserver_shims_grad_scale_and_refusal(tmp_path):
    from paddle_tpu_torch import fluid

    # single-device references, in the port: the gradient of the global
    # batch, and the served block's training
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(
            input=x, size=1,
            param_attr=fluid.ParamAttr(
                name="t_w", initializer=fluid.initializer.Constant(0.1)))
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        rng = np.random.RandomState(0)
        xd = rng.randn(16, 4).astype(np.float32)
        yd = xd.sum(axis=1, keepdims=True).astype(np.float32)
        single = [exe.run(feed={"x": xd, "y": yd},
                          fetch_list=[loss, "t_w@GRAD"]) for _ in range(2)]
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        cost, serv, params_grads = served_net(fluid)
        sp, sg = serv.get_params_and_grads()
        assert sp == [p.name for p, _ in params_grads]
        assert sg == [g.name for _, g in params_grads]
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(fluid.default_startup_program())
        for xb, yb in served_batches():
            exe.run(feed={"x": xb, "y": yb}, fetch_list=[cost])
        served = fluid.fetch_var("w_serv")
    with pytest.raises(ValueError, match="unregistered endpoint"):
        fluid.layers.Send("10.0.0.9:9999", [], [])

    outs = spawn(_transpiler_worker, 2, tmp_path)
    for o in outs:
        assert o["same_program"] and o["mesh"] == {"data": 2}
        assert o["places"] == 2
        assert o["losses"][1] < o["losses"][0]
        np.testing.assert_allclose(o["losses"],
                                   [float(s[0][0]) for s in single],
                                   rtol=1e-5)
        # world-2 gradient == the single-device gradient (not 2x it)
        np.testing.assert_allclose(o["grad"], single[0][1], rtol=1e-5)
        assert o["async_warned"] >= 2
        np.testing.assert_allclose(o["served"], served, rtol=1e-5)
        assert o["refused"] and "'concat'" in o["refused"]


# --- a ragged LSTM over two ranks ------------------------------------------

VOCAB, N_SEQS, H = 12, 8, 6


def lstm_net(fluid):
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    label = fluid.layers.data(name="y", shape=[1], dtype="int64")
    emb = fluid.layers.embedding(input=words, size=[VOCAB, 8])
    proj = fluid.layers.fc(input=emb, size=H * 4)
    hidden, _ = fluid.layers.dynamic_lstm(input=proj, size=H * 4)
    last = fluid.layers.sequence_last_step(input=hidden)
    pred = fluid.layers.fc(input=last, size=3, act="softmax")
    loss = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=pred, label=label))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def lstm_batch(step, lo=0, hi=N_SEQS):
    rng = np.random.RandomState(777 + step)
    lens = rng.randint(2, 7, N_SEQS)
    seqs = [rng.randint(0, VOCAB, n) for n in lens]
    labels = (np.asarray([s.sum() for s in seqs]) % 3).astype(np.int64)
    sel = seqs[lo:hi]
    flat = np.concatenate(sel).reshape(-1, 1).astype(np.int64)
    offsets = np.cumsum([0] + [len(s) for s in sel]).astype(np.int32)
    return (flat, [offsets]), labels[lo:hi].reshape(-1, 1)


def _lstm_worker(rank, world, snap, steps):
    from paddle_tpu_torch import fluid, parallel

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss = lstm_net(fluid)
        exe = fluid.Executor(mesh=parallel.make_mesh({"data": world},
                                                     device="cpu"))
        load_snapshot(fluid, main, fluid.global_scope(), snap)
        exe._run_counter = 1
        half = N_SEQS // world
        losses = []
        for step in range(steps):
            words, ys = lstm_batch(step, rank * half, (rank + 1) * half)
            losses.append(float(exe.run(
                main, feed={"words": words, "y": ys},
                fetch_list=[loss])[0][0]))
        return dict(losses=losses, state=snapshot(
            main, fluid.scope_to_numpy(fluid.global_scope()).__getitem__))


def test_two_rank_ragged_lstm_matches_the_single_device_run(tmp_path):
    import paddle_tpu.fluid as JF

    steps = 4
    main, startup = JF.Program(), JF.Program()
    with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
        loss = lstm_net(JF)
        exe = JF.Executor(JF.CPUPlace())
        exe.run(startup)
        snap = snapshot(main, JF.global_scope().get)
        losses = []
        for step in range(steps):
            words, ys = lstm_batch(step)
            losses.append(float(np.ravel(exe.run(
                main, feed={"words": words, "y": ys},
                fetch_list=[loss])[0])[0]))
        state = dict(snapshot(main, JF.global_scope().get))
    outs = spawn(_lstm_worker, 2, tmp_path, snap, steps)
    for o in outs:
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-4,
                                   atol=1e-6)
        for pos, got in o["state"]:
            np.testing.assert_allclose(got, state[pos], rtol=1e-4,
                                       atol=1e-6)
