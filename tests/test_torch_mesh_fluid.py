"""The port's Fluid executor on a mesh of CPU ranks (gloo, spawned by
tests/torch_mesh.py) against the JAX package's executor on the
conftest's virtual-device mesh: data-, tensor- and FSDP-parallel, hybrid
dcn x data, ParallelDo, batch norm, dropout, ModelAverage, the order of
per-example fetches and the gradient's scale. Every check holds the
global-batch semantics: a mesh run equals the single-device run on the
concatenated batch, at the JAX tests' tolerances (rtol 1e-5 in f32,
tests/test_parallel.py). Weights that are drawn at random cross from
the JAX scope as numpy, paired by position in the programs' variables
(both packages build the same variables in the same order).

jax and the JAX package are imported inside the tests only: the ranks
import this module too."""

import os

import numpy as np

from torch_mesh import load_snapshot, snapshot, spawn

B = 32  # global batch of every check




def _rows(rank, n, *arrays):
    b = arrays[0].shape[0] // n
    return [a[rank * b:(rank + 1) * b] for a in arrays]


# --- programs both packages build ---------------------------------------

def linreg(fluid):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(
        input=x, size=1,
        param_attr=fluid.ParamAttr(
            name="fc_w", initializer=fluid.initializer.Constant(0.5)),
        bias_attr=fluid.ParamAttr(
            name="fc_b", initializer=fluid.initializer.Constant(0.0)))
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss, pred


def tp_net(fluid, spec):
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[4], dtype="float32")
    h = fluid.layers.fc(
        input=x, size=64, act="relu",
        param_attr=fluid.ParamAttr(
            name="w1", initializer=fluid.initializer.Constant(0.01)))
    out = fluid.layers.fc(
        input=h, size=4,
        param_attr=fluid.ParamAttr(
            name="w2", initializer=fluid.initializer.Constant(0.02)))
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=out, label=y))
    if spec is not None:
        spec(fluid.default_main_program().global_block().var("w1"))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss, out


def fsdp_net(fluid):
    x = fluid.layers.data(name="x", shape=[32], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(
        input=x, size=64, act="relu",
        param_attr=fluid.ParamAttr(
            name="fsdp_w1",
            initializer=fluid.initializer.Normal(scale=0.1, seed=41)))
    pred = fluid.layers.fc(
        input=h, size=1,
        param_attr=fluid.ParamAttr(
            name="fsdp_w2",
            initializer=fluid.initializer.Normal(scale=0.1, seed=42)))
    return fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))


def hybrid_net(fluid):
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    pred = fluid.layers.fc(input=x, size=1)
    loss = fluid.layers.mean(x=fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def data(seed):
    rng = np.random.RandomState(seed)
    return {
        "lin_x": rng.rand(B, 8).astype(np.float32),
        "lin_w": rng.rand(8, 1).astype(np.float32),
        "tp_x": rng.rand(B, 32).astype(np.float32),
        "tp_y": rng.rand(B, 4).astype(np.float32),
        "fs_x": rng.randn(B, 32).astype(np.float32),
        "fs_y": rng.randn(B, 1).astype(np.float32),
        "hy": [(rng.randn(B, 6).astype(np.float32),
                rng.randn(B, 1).astype(np.float32)) for _ in range(3)],
    }


# --- the first group: data, tensor, FSDP, hybrid -------------------------

def _dense_worker(rank, world, d, hybrid_snap, tmp):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.parallel.mesh import P

    out = {}
    lin_y = d["lin_x"] @ d["lin_w"]

    # data parallel over 'data': 4 ranks of 8 rows
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        loss, pred = linreg(fluid)
        mesh = parallel.make_mesh({"data": 4}, device="cpu")
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        x, y = _rows(rank, 4, d["lin_x"], lin_y)
        losses, preds, grads = [], [], []
        for _ in range(5):
            lv, pv, gv = exe.run(feed={"x": x, "y": y},
                                 fetch_list=[loss, pred, "fc_w@GRAD"])
            losses.append(float(lv[0]))
            preds.append(pv)
            grads.append(gv)
        out["dp"] = dict(losses=losses, w=fluid.fetch_var("fc_w"),
                         preds=preds, grads=grads)

    # tensor parallel: w1 split over 'model' (columns), batch over 'data'
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        loss, o = tp_net(fluid, lambda w: parallel.shard_parameter(
            w, P(None, "model")))
        mesh = parallel.make_mesh({"data": 2, "model": 2}, device="cpu")
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        x, y = _rows(mesh.index("data"), 2, d["tp_x"], d["tp_y"])
        outs = [exe.run(feed={"x": x, "y": y}, fetch_list=[o, loss])
                for _ in range(3)]
        scope = fluid.global_scope()
        saved = os.path.join(tmp, "saved_%d" % rank)
        fluid.io.save_persistables(exe, saved)
        out["tp"] = dict(out=[a for a, _ in outs],
                         losses=[float(b[0]) for _, b in outs],
                         w1=fluid.fetch_var("w1"),
                         w1_saved=np.load(os.path.join(saved, "w1.npy")),
                         w1_here=tuple(scope.get("w1").shape))

    # FSDP over 'data' with Adam: parameters and slots hold 1/4 a rank
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        loss = fsdp_net(fluid)
        main = fluid.default_main_program()
        mesh = parallel.make_mesh({"data": 4}, device="cpu")
        sharded = parallel.shard_parameters_fsdp(main, mesh, min_size=64)
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
        exe = fluid.Executor(mesh=mesh)
        exe.run(fluid.default_startup_program())
        x, y = _rows(rank, 4, d["fs_x"], d["fs_y"])
        for _ in range(4):
            exe.run(feed={"x": x, "y": y}, fetch_list=[loss])
        scope = fluid.global_scope()
        slots = [k for k in main.shardings if k != "fsdp_w1"
                 and "fsdp_w1" in k]
        out["fsdp"] = dict(
            sharded=sharded, w1=fluid.fetch_var("fsdp_w1"),
            here={k: tuple(scope.get(k).shape)
                  for k in ["fsdp_w1"] + slots},
            specs={k: tuple(v) for k, v in main.shardings.items()})

    # hybrid dcn x data: the batch splits over both tiers
    with fluid.program_guard(fluid.Program(), fluid.Program()), \
            fluid.scope_guard(fluid.Scope()):
        loss = hybrid_net(fluid)
        main = fluid.default_main_program()
        mesh = parallel.make_hybrid_mesh({"dcn": 2}, {"data": 2},
                                         device="cpu")
        exe = fluid.Executor(mesh=mesh)
        load_snapshot(fluid, main, fluid.global_scope(), hybrid_snap)
        exe._run_counter = 1
        i = mesh.index(("dcn", "data"))
        losses = [float(exe.run(feed=dict(zip(("x", "y"), _rows(
            i, 4, xs, ys))), fetch_list=[loss])[0][0]) for xs, ys in d["hy"]]
        w = main.global_block().all_parameters()[0].name
        out["hybrid"] = dict(losses=losses, w=fluid.fetch_var(w))
    return out


def _jax_runs(d):
    """The JAX package's mesh runs of the first group."""
    import jax.sharding
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    ref = {}
    lin_y = d["lin_x"] @ d["lin_w"]
    with JF.program_guard(JF.Program(), JF.Program()), \
            JF.scope_guard(JF.Scope()):
        loss, pred = linreg(JF)
        exe = JF.Executor(mesh=jp.make_mesh({"data": 8}))
        exe.run(JF.default_startup_program())
        runs = [exe.run(feed={"x": d["lin_x"], "y": lin_y},
                        fetch_list=[loss, pred, "fc_w@GRAD"])
                for _ in range(5)]
        ref["dp"] = dict(losses=[float(r[0][0]) for r in runs],
                         preds=[r[1] for r in runs],
                         grads=[r[2] for r in runs],
                         w=np.asarray(JF.global_scope().get("fc_w")))
    with JF.program_guard(JF.Program(), JF.Program()), \
            JF.scope_guard(JF.Scope()):
        loss, o = tp_net(JF, lambda w: jp.shard_parameter(
            w, jax.sharding.PartitionSpec(None, "model")))
        exe = JF.Executor(mesh=jp.make_mesh({"data": 2, "model": 4}))
        exe.run(JF.default_startup_program())
        outs = [exe.run(feed={"x": d["tp_x"], "y": d["tp_y"]},
                        fetch_list=[o, loss]) for _ in range(3)]
        ref["tp"] = dict(out=[a for a, _ in outs],
                         losses=[float(b[0]) for _, b in outs],
                         w1=np.asarray(JF.global_scope().get("w1")))
    with JF.program_guard(JF.Program(), JF.Program()), \
            JF.scope_guard(JF.Scope()):
        loss = fsdp_net(JF)
        main = JF.default_main_program()
        mesh = jp.make_mesh({"data": 4})
        jp.shard_parameters_fsdp(main, mesh, min_size=64)
        JF.optimizer.Adam(learning_rate=0.01).minimize(loss)
        exe = JF.Executor(mesh=mesh)
        exe.run(JF.default_startup_program())
        for _ in range(4):
            exe.run(feed={"x": d["fs_x"], "y": d["fs_y"]},
                    fetch_list=[loss])
        ref["fsdp"] = dict(w1=np.asarray(JF.global_scope().get("fsdp_w1")),
                           specs={k: tuple(v)
                                  for k, v in main.shardings.items()})
    main, startup = JF.Program(), JF.Program()
    with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
        loss = hybrid_net(JF)
        exe = JF.Executor(mesh=jp.make_hybrid_mesh(
            {"dcn": 2}, {"data": 2, "model": 2}))
        exe.run(startup)
        snap = snapshot(main, JF.global_scope().get)
        losses = [float(exe.run(main, feed={"x": xs, "y": ys},
                                fetch_list=[loss])[0][0])
                  for xs, ys in d["hy"]]
        w = main.global_block().all_parameters()[0].name
        ref["hybrid"] = dict(losses=losses,
                             w=np.asarray(JF.global_scope().get(w)))
    return ref, snap


def test_data_tensor_fsdp_and_hybrid_match_the_jax_mesh(tmp_path):
    d = data(3)
    ref, snap = _jax_runs(d)
    outs = spawn(_dense_worker, 4, tmp_path, d, snap, str(tmp_path))
    for o in outs:
        # data parallel (tests/test_parallel.py:41): losses and params
        np.testing.assert_allclose(o["dp"]["losses"], ref["dp"]["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["dp"]["w"], ref["dp"]["w"], rtol=1e-5)
        # per-example fetches come back whole, in the global batch order
        for got, want in zip(o["dp"]["preds"], ref["dp"]["preds"]):
            assert got.shape == (B, 1)
            np.testing.assert_allclose(got, want, rtol=1e-5)
        # the gradient is the global-batch gradient, not world x it
        for got, want in zip(o["dp"]["grads"], ref["dp"]["grads"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        # tensor parallel (:65): outputs, losses, the trained weight
        for got, want in zip(o["tp"]["out"], ref["tp"]["out"]):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(o["tp"]["losses"], ref["tp"]["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(o["tp"]["w1"], ref["tp"]["w1"],
                                   rtol=1e-5, atol=1e-7)
        assert o["tp"]["w1_here"] == (32, 32)  # half of [32, 64]
        np.testing.assert_array_equal(o["tp"]["w1_saved"], o["tp"]["w1"])
        # FSDP (:113): the same dims, 1/4 of w1 and of each slot here
        # (fc's [64] bias reaches min_size 64 too, as in the JAX package)
        assert {"fsdp_w1", "fsdp_w2"} <= set(o["fsdp"]["sharded"])
        assert sorted(map(repr, o["fsdp"]["specs"].values())) == \
            sorted(map(repr, ref["fsdp"]["specs"].values()))
        here = o["fsdp"]["here"]
        assert len(here) == 3  # w1, its two Adam moments
        assert all(v == (32, 16) for v in here.values()), here
        np.testing.assert_allclose(o["fsdp"]["w1"], ref["fsdp"]["w1"],
                                   rtol=0, atol=2e-5)
        # hybrid dcn x data (tests/test_hybrid_mesh.py:17-90)
        np.testing.assert_allclose(o["hybrid"]["losses"],
                                   ref["hybrid"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(o["hybrid"]["w"], ref["hybrid"]["w"],
                                   rtol=1e-5)


# --- the second group: ParallelDo, batch norm, dropout, ModelAverage -----

def pd_net(fluid, use_pd):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")

    def head(x_, y_):
        h = fluid.layers.fc(input=x_, size=16, act="relu")
        p = fluid.layers.fc(input=h, size=4, act="softmax")
        return fluid.layers.mean(
            x=fluid.layers.cross_entropy(input=p, label=y_))

    if use_pd:
        pd = fluid.layers.ParallelDo(fluid.layers.get_places())
        with pd.do():
            x_, y_ = pd.read_input(x), pd.read_input(y)
            pd.write_output(head(x_, y_))
        loss = fluid.layers.mean(x=pd())
    else:
        loss = head(x, y)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def bn_net(fluid):
    img = fluid.layers.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    c = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                            padding=1)
    c = fluid.layers.batch_norm(input=c, act="relu")
    c = fluid.layers.pool2d(input=c, pool_size=2, pool_stride=2)
    pred = fluid.layers.fc(input=c, size=5, act="softmax")
    loss = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=pred, label=label))
    acc = fluid.layers.accuracy(input=pred, label=label)
    fluid.optimizer.Momentum(learning_rate=0.05,
                             momentum=0.9).minimize(loss)
    return loss, acc


def drop_net(fluid):
    x = fluid.layers.data(name="x", shape=[16], dtype="float32")
    h = fluid.layers.fc(input=x, size=24)
    h = fluid.layers.dropout(h, dropout_prob=0.4)
    loss = fluid.layers.mean(x=h)
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss, h


def ma_net(fluid, spec):
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(
        input=x, size=16, act="tanh",
        param_attr=fluid.ParamAttr(
            name="ma_w1", initializer=fluid.initializer.Constant(0.05)))
    pred = fluid.layers.fc(
        input=h, size=1,
        param_attr=fluid.ParamAttr(
            name="ma_w2", initializer=fluid.initializer.Constant(0.1)))
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    if spec is not None:
        spec(fluid.default_main_program().global_block().var("ma_w1"))
    fluid.optimizer.Momentum(learning_rate=0.1, momentum=0.9).minimize(loss)
    ma = fluid.optimizer.ModelAverage(average_window=0.5,
                                      min_average_window=2,
                                      max_average_window=4).build()
    return loss, ma


def reduce_net(fluid):
    """Batch reductions with global forms: max / min / prod / mean over
    the batch (the max's gradient trains fc), auc, and sampling_id's
    draw (this rank's rows of the global draw)."""
    x = fluid.layers.data(name="x", shape=[6], dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    h = fluid.layers.fc(
        input=x, size=4,
        param_attr=fluid.ParamAttr(
            name="red_w", initializer=fluid.initializer.Constant(0.1)))
    prob = fluid.layers.softmax(fluid.layers.fc(input=x, size=2))
    outs = dict(
        hmax=fluid.layers.reduce_max(h, dim=0),
        xmin=fluid.layers.reduce_min(x, dim=None),
        xprod=fluid.layers.reduce_prod(
            fluid.layers.scale(x, scale=0.1, bias=1.0), dim=0),
        xmean=fluid.layers.reduce_mean(x, dim=[0, 1], keep_dim=True),
        auc=fluid.layers.auc(input=prob, label=label),
        ids=fluid.layers.sampling_id(prob))
    loss = fluid.layers.mean(x=outs["hmax"])
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return loss, outs


def clip_net(fluid):
    """fc regression whose gradients clip by their global norm, and one
    by its own norm (both small enough to bind): over FSDP shards the
    norms sum over the ranks."""
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(
        input=x, size=16, act="tanh",
        param_attr=fluid.ParamAttr(
            name="clip_w1", initializer=fluid.initializer.Constant(0.05)))
    pred = fluid.layers.fc(
        input=h, size=1,
        param_attr=fluid.ParamAttr(
            name="clip_w2", initializer=fluid.initializer.Constant(0.1)))
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    params = fluid.default_main_program().global_block().all_parameters()
    fluid.clip.set_gradient_clip(
        fluid.clip.GradientClipByGlobalNorm(clip_norm=0.01),
        param_list=[p for p in params if p.name != "clip_w2"])
    # clip_by_norm over a shard: its parameter's whole norm
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByNorm(0.005),
                                 param_list=["clip_w2"])
    return loss


def _run_clip(fluid, exe, feed, mesh=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss = clip_net(fluid)
        sharded = []
        if mesh is not None:
            from paddle_tpu_torch import parallel

            sharded = parallel.shard_parameters_fsdp(main, mesh,
                                                     min_size=16)
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        exe.run(startup)
        losses = [float(exe.run(main, feed=feed, fetch_list=[loss])[0][0])
                  for _ in range(3)]
        return dict(losses=losses, sharded=sharded,
                    w1=fluid.fetch_var("clip_w1"),
                    w2=fluid.fetch_var("clip_w2"))


def data2(seed):
    rng = np.random.RandomState(seed)
    img = rng.randn(B, 3, 8, 8).astype(np.float32)
    return {
        "pd_x": rng.randn(B, 8).astype(np.float32),
        "pd_y": rng.randint(0, 4, (B, 1)).astype(np.int64),
        "bn_img": img - img.mean(axis=0, keepdims=True),
        "bn_label": rng.randint(0, 5, (B, 1)).astype(np.int64),
        "dr_x": rng.randn(B, 16).astype(np.float32),
        "ma_x": rng.randn(B, 8).astype(np.float32),
        "ma_y": rng.randn(B, 1).astype(np.float32),
        "red_x": rng.rand(B, 6).astype(np.float32),
        "red_label": rng.randint(0, 2, (B, 1)).astype(np.int64),
        "clip_y": rng.randn(B, 1).astype(np.float32),
    }


def _run_reduce(fluid, exe, feed):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss, outs = reduce_net(fluid)
        exe.run(startup)
        keys = sorted(outs)
        got = exe.run(main, feed=feed,
                      fetch_list=[loss] + [outs[k] for k in keys])
        return dict(zip(["loss"] + keys, got), w=fluid.fetch_var("red_w"))


def _rest_worker(rank, world, d, snaps):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.parallel.mesh import P

    out = {}
    mesh = parallel.make_mesh({"data": 4}, device="cpu")

    # ParallelDo on a mesh: the mesh is the per-place split
    curves = {}
    for use_pd in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(fluid.Scope()):
            loss = pd_net(fluid, use_pd)
            exe = fluid.Executor(fluid.CPUPlace(), mesh=mesh)
            load_snapshot(fluid, main, fluid.global_scope(),
                          snaps["pd"][use_pd])
            exe._run_counter = 1
            x, y = _rows(rank, 4, d["pd_x"], d["pd_y"])
            curves[use_pd] = [float(exe.run(main, feed={"x": x, "y": y},
                                            fetch_list=[loss])[0][0])
                              for _ in range(5)]
    out["pd"] = curves

    # batch norm's statistics over the global batch
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss, acc = bn_net(fluid)
        exe = fluid.Executor(mesh=mesh)
        load_snapshot(fluid, main, fluid.global_scope(), snaps["bn"])
        exe._run_counter = 1
        img, label = _rows(rank, 4, d["bn_img"], d["bn_label"])
        runs = [exe.run(main, feed={"img": img, "label": label},
                        fetch_list=[loss, acc]) for _ in range(3)]
        state = fluid.scope_to_numpy(fluid.global_scope())
        tv = list(main.global_block().vars.values())
        pos = {v.name: i for i, v in enumerate(tv)}
        out["bn"] = dict(losses=[float(r[0][0]) for r in runs],
                         accs=[float(r[1][0]) for r in runs],
                         state={pos[k]: v for k, v in state.items()
                                if k in pos})

    # dropout: this rank's rows of the global draw
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss, h = drop_net(fluid)
        exe = fluid.Executor(mesh=mesh)
        load_snapshot(fluid, main, fluid.global_scope(), snaps["drop"])
        exe._run_counter = 1
        (x,) = _rows(rank, 4, d["dr_x"])
        out["drop"] = [exe.run(main, feed={"x": x}, fetch_list=[h, loss])
                       for _ in range(2)]

    # the other batch reductions with a global form
    x, label = _rows(rank, 4, d["red_x"], d["red_label"])
    out["reduce"] = _run_reduce(fluid, fluid.Executor(mesh=mesh),
                                {"x": x, "label": label})

    # clipping by the global norm over FSDP shards
    x, y = _rows(rank, 4, d["ma_x"], d["clip_y"])
    out["clip"] = _run_clip(fluid, fluid.Executor(mesh=mesh),
                            {"x": x, "y": y}, mesh)

    # ModelAverage on a data x model mesh, w1 split over 'model'
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss, ma = ma_net(fluid, lambda w: parallel.shard_parameter(
            w, P(None, "model")))
        tpm = parallel.make_mesh({"data": 2, "model": 2}, device="cpu")
        exe = fluid.Executor(mesh=tpm)
        exe.run(startup)
        x, y = _rows(tpm.index("data"), 2, d["ma_x"], d["ma_y"])
        losses = [float(exe.run(main, feed={"x": x, "y": y},
                                fetch_list=[loss])[0][0]) for _ in range(4)]
        scope = fluid.global_scope()
        out["ma"] = dict(
            losses=losses, w1=fluid.fetch_var("ma_w1"),
            here={k: tuple(scope.get(k).shape) for k in
                  ["ma_w1"] + ["ma_w1" + s for s in ma.SUM_SUFFIXES]})
        with ma.apply():
            out["ma"]["averaged"] = fluid.fetch_var("ma_w1")
    return out


def _single_ma(d):
    """ModelAverage on one CPU device: the port's own reference."""
    from paddle_tpu_torch import fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), \
            fluid.scope_guard(fluid.Scope()):
        loss, ma = ma_net(fluid, None)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        losses = [float(exe.run(main, feed={"x": d["ma_x"], "y": d["ma_y"]},
                                fetch_list=[loss])[0][0]) for _ in range(4)]
        w1 = fluid.fetch_var("ma_w1")
        with ma.apply():
            avg = fluid.fetch_var("ma_w1")
    return dict(losses=losses, w1=w1, averaged=avg)


def _jax_rest(d):
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    ref, snaps = {}, {"pd": {}}
    mesh = jp.make_mesh({"data": 4})
    curves = {}
    for use_pd in (False, True):
        main, startup = JF.Program(), JF.Program()
        with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
            loss = pd_net(JF, use_pd)
            exe = JF.Executor(JF.CPUPlace(), mesh=mesh)
            exe.run(startup)
            snaps["pd"][use_pd] = snapshot(main, JF.global_scope().get)
            curves[use_pd] = [float(exe.run(
                main, feed={"x": d["pd_x"], "y": d["pd_y"]},
                fetch_list=[loss])[0][0]) for _ in range(5)]
    ref["pd"] = curves
    main, startup = JF.Program(), JF.Program()
    with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
        loss, acc = bn_net(JF)
        exe = JF.Executor(mesh=mesh)
        exe.run(startup)
        snaps["bn"] = snapshot(main, JF.global_scope().get)
        runs = [exe.run(main, feed={"img": d["bn_img"],
                                    "label": d["bn_label"]},
                        fetch_list=[loss, acc]) for _ in range(3)]
        ref["bn"] = dict(losses=[float(r[0][0]) for r in runs],
                         accs=[float(r[1][0]) for r in runs],
                         state=dict(snapshot(main, JF.global_scope().get)))
    main, startup = JF.Program(), JF.Program()
    with JF.program_guard(main, startup), JF.scope_guard(JF.Scope()):
        loss, h = drop_net(JF)
        exe = JF.Executor(mesh=mesh)
        exe.run(startup)
        snaps["drop"] = snapshot(main, JF.global_scope().get)
        ref["drop"] = [exe.run(main, feed={"x": d["dr_x"]},
                               fetch_list=[h, loss]) for _ in range(2)]
    return ref, snaps


def test_parallel_do_batch_norm_dropout_and_model_average(tmp_path):
    d = data2(5)
    ref, snaps = _jax_rest(d)
    single = _single_ma(d)
    from paddle_tpu_torch import fluid

    red = _run_reduce(fluid, fluid.Executor(fluid.CPUPlace()),
                      {"x": d["red_x"], "label": d["red_label"]})
    clip = _run_clip(fluid, fluid.Executor(fluid.CPUPlace()),
                     {"x": d["ma_x"], "y": d["clip_y"]})
    outs = spawn(_rest_worker, 4, tmp_path, d, snaps)
    for o in outs:
        # max / min / prod / mean over the batch, auc, sampling_id's
        # draw, and the max's gradient: the one-device values
        # the global norm over shards clips as on one device
        assert {"clip_w1", "clip_w2"} <= set(o["clip"]["sharded"])
        for k in ("losses", "w1", "w2"):
            np.testing.assert_allclose(o["clip"][k], clip[k], rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        assert set(o["reduce"]) == set(red)
        for k, want in red.items():
            np.testing.assert_allclose(o["reduce"][k], want, rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        # ParallelDo (tests/test_parallel_do.py:15-80): both curves equal
        # the JAX mesh's and each other
        for use_pd in (False, True):
            np.testing.assert_allclose(o["pd"][use_pd], ref["pd"][use_pd],
                                       rtol=1e-5)
        np.testing.assert_allclose(o["pd"][True], o["pd"][False], rtol=1e-5)
        # batch norm over the global batch: losses, accuracy, and every
        # persistable (params, running statistics, momenta)
        np.testing.assert_allclose(o["bn"]["losses"], ref["bn"]["losses"],
                                   rtol=1e-5)
        assert o["bn"]["accs"] == ref["bn"]["accs"]
        for pos, want in ref["bn"]["state"].items():
            np.testing.assert_allclose(o["bn"]["state"][pos], want,
                                       rtol=1e-4, atol=1e-6)
        # dropout: the mask of the global draw, gathered in rank order
        for (h, lv), (jh, jl) in zip(o["drop"], ref["drop"]):
            assert h.shape == (B, 24)
            np.testing.assert_allclose(h, jh, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(h == 0, jh == 0)
            np.testing.assert_allclose(lv, jl, rtol=1e-5)
        # ModelAverage on a mesh matches the single-device run; its sum
        # slots hold the parameter's shard
        ma = o["ma"]
        np.testing.assert_allclose(ma["losses"], single["losses"],
                                   rtol=1e-5)
        np.testing.assert_allclose(ma["w1"], single["w1"], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(ma["averaged"], single["averaged"],
                                   rtol=1e-5, atol=1e-7)
        assert all(v == (8, 8) for v in ma["here"].values()), ma["here"]


def test_model_average_sum_slots_inherit_the_spec():
    """The sum slots of a parameter with a spec carry its spec (the JAX
    package's optimizer.py:610-619), so a mesh holds them as shards."""
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.parallel.mesh import P, shard_parameter

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        ma_net(fluid, lambda w: shard_parameter(w, P(None, "model")))
    specs = main.shardings
    for sfx in fluid.optimizer.ModelAverage.SUM_SUFFIXES:
        assert specs["ma_w1" + sfx] == P(None, "model")
    # the counters and the unsharded parameter's slots have none
    assert not any(k.startswith("ma_w2@") for k in specs)
    assert not any(k.endswith(("@NUM_ACC", "@OLD_NUM_ACC", "@NUM_UPD"))
                   for k in specs)
