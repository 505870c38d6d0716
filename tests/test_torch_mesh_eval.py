"""Eval programs and the kernels that compute their own global forms on
the port's mesh executor (fluid/core/spmd.py `_MANAGED`), against the
JAX package's mesh (the conftest's virtual devices) from the same
weights: batch norm in eval mode (a `clone(for_test=True)` program,
`is_test=True` on the op, NHWC), batch norm over a value split along
its channel axis (read whole), and a table of the managed ops' branches
(`reduce_*` on and off the split dimension, with and without
`keep_dim`, `reduce_all`; `mean`, the norms, `isfinite`, `shape`,
`is_empty`; `lookup_table` dense, sparse and with `padding_idx`;
`accuracy` at k 1 and 5; `auc` and `precision_recall` after an
eval-mode batch norm). f32, rtol 1e-5 and atol 1e-7 (1e-6 absolute where
a value comes out of a cancellation); counts, flags and shapes equal.

The port's ranks run in one module-scoped spawn of two gloo CPU ranks
({data: 2}, tests/torch_mesh.py); jax stays in the pytest process."""

import traceback

import numpy as np
import pytest

from torch_mesh import collect, load_snapshot, once, snapshot, start

B = 32  # the global batch of every case
STEPS = 2
RTOL, ATOL = 1e-5, 1e-7
# values that come out of a cancellation between operands of order 1
# (a trained weight's element near 0, batch norm's output near its
# mean) differ by an f32 ulp of those operands: absolute 1e-6 there
# (tests/test_torch_mesh_fluid.py holds batch norm's state at 1e-6 too)
CANCEL_ATOL = 1e-6


def _param(fluid, name, seed, scale=0.5):
    return fluid.ParamAttr(
        name=name, initializer=fluid.initializer.Normal(scale=scale,
                                                        seed=seed))


def _raw(fluid, op_type, x, dtype, slot="X"):
    """An op with no layer function: one input, one output."""
    helper = fluid.layer_helper.LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type=op_type, inputs={slot: [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


def _train(fluid, loss, fetch, opt="momentum"):
    """(fetch, the eval clone taken before the optimizer's ops)."""
    test = fluid.default_main_program().clone(for_test=True)
    if opt == "momentum":
        fluid.optimizer.Momentum(learning_rate=0.05,
                                 momentum=0.9).minimize(loss)
    else:
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return fetch, test


# --- the programs both packages build ------------------------------------

def bn_net(fluid, is_test=False, layout="NCHW"):
    """tests/test_torch_mesh_fluid.py's `bn_net`, with the batch norm in
    eval mode on the op itself or over an NHWC view."""
    L = fluid.layers
    img = L.data(name="img", shape=[3, 8, 8], dtype="float32")
    label = L.data(name="label", shape=[1], dtype="int64")
    c = L.conv2d(input=img, num_filters=4, filter_size=3, padding=1)
    if layout == "NHWC":
        c = L.transpose(c, perm=[0, 2, 3, 1])
    c = L.batch_norm(input=c, act="relu", is_test=is_test,
                     data_layout=layout)
    if layout == "NHWC":
        c = L.transpose(c, perm=[0, 3, 1, 2])
    c = L.pool2d(input=c, pool_size=2, pool_stride=2)
    pred = L.fc(input=c, size=5, act="softmax")
    loss = L.mean(x=L.cross_entropy(input=pred, label=label))
    acc = L.accuracy(input=pred, label=label)
    return _train(fluid, loss, [pred, loss, acc])


def channel_split(fluid):
    """A batch-split NCHW value transposed so that the batch lies on
    dimension 1, batch norm's channel axis: each example is normalised
    over its (C, H, W), and the op reads the value whole."""
    L = fluid.layers
    img = L.data(name="cimg", shape=[B, 3, 8, 8], dtype="float32",
                 append_batch_size=False)
    label = L.data(name="clabel", shape=[B, 1], dtype="int64",
                   append_batch_size=False)
    c = L.conv2d(input=img, num_filters=4, filter_size=3, padding=1)
    t = L.batch_norm(input=L.transpose(c, perm=[1, 0, 2, 3]), act="relu")
    c = L.transpose(t, perm=[1, 0, 2, 3])
    c = L.pool2d(input=c, pool_size=2, pool_stride=2)
    pred = L.fc(input=c, size=5, act="softmax")
    loss = L.mean(x=L.cross_entropy(input=pred, label=label))
    return _train(fluid, loss, [pred, loss, t])


REDUCE_KINDS = ("sum", "mean", "max", "min", "prod")
# x is [B, 6, 4], split along dim 0: dims on and off the split, None
# for reduce_all
REDUCE_DIMS = (0, 1, [0, 2], -1, None)
REDUCES = [(k, d, keep) for k in REDUCE_KINDS for d in REDUCE_DIMS
           for keep in (False, True)]
NORMS = ("mean", "squared_l2_norm", "l1_norm", "isfinite", "isfinite_inf",
         "shape", "is_empty")


def _reduce_id(kind, dim, keep):
    return "reduce_%s dim %s%s" % (kind, "all" if dim is None else dim,
                                   " keep" if keep else "")


def managed(fluid):
    L = fluid.layers
    x = L.data(name="rx", shape=[6, 4], dtype="float32")
    z = L.data(name="rz", shape=[3], dtype="float32")
    a = L.data(name="ax", shape=[8], dtype="float32")
    y = L.data(name="ay", shape=[1], dtype="int64")
    fetch = [getattr(L, "reduce_" + k)(x, dim=d, keep_dim=keep)
             for k, d, keep in REDUCES]
    fetch += [L.mean(x), _raw(fluid, "squared_l2_norm", x, "float32"),
              _raw(fluid, "l1_norm", x, "float32"),
              _raw(fluid, "isfinite", x, "bool"),
              _raw(fluid, "isfinite", z, "bool"),
              _raw(fluid, "shape", x, "int32", "Input"),
              _raw(fluid, "is_empty", x, "bool")]
    pred = L.fc(input=a, size=10, act="softmax",
                param_attr=_param(fluid, "mg_w", 21))
    fetch += [L.accuracy(input=pred, label=y, k=k) for k in (1, 5)]
    return fetch, None


LOOKUPS = ("dense", "sparse", "padding_idx")


def lookup(fluid):
    L = fluid.layers
    ids = L.data(name="ids", shape=[1], dtype="int64")
    y = L.data(name="ly", shape=[1], dtype="float32")
    embs = [L.embedding(input=ids, size=[20, 6], is_sparse=kind == "sparse",
                        padding_idx=3 if kind == "padding_idx" else None,
                        param_attr=_param(fluid, "lk_" + kind, 30 + i))
            for i, kind in enumerate(LOOKUPS)]
    pred = L.fc(input=L.concat(embs, axis=1), size=1,
                param_attr=_param(fluid, "lk_w", 33))
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    return _train(fluid, loss, embs + [loss], opt="sgd")


METRICS = ("auc", "precision_recall batch", "precision_recall accum",
           "precision_recall states")


def metrics_after_bn(fluid):
    L = fluid.layers
    img = L.data(name="mimg", shape=[3, 8, 8], dtype="float32")
    label = L.data(name="mlabel", shape=[1], dtype="int64")
    c = L.conv2d(input=img, num_filters=4, filter_size=3, padding=1)
    c = L.batch_norm(input=c, is_test=True)
    pred = L.fc(input=c, size=2, act="softmax",
                param_attr=_param(fluid, "mb_w", 40, scale=0.1))
    _, idx = L.topk(pred, k=1)
    batch, accum, states = L.precision_recall(input=idx, label=label,
                                              class_number=2)
    return [L.auc(input=pred, label=label), batch, accum, states], None


BUILDS = {
    "bn_clone": bn_net,
    "bn_is_test": lambda f: bn_net(f, is_test=True),
    "bn_nhwc": lambda f: bn_net(f, layout="NHWC"),
    "channel_split": channel_split,
    "managed": managed,
    "lookup": lookup,
    "metrics": metrics_after_bn,
}
BN_CASES = ("bn_clone", "bn_is_test", "bn_nhwc")


def _feeds(seed):
    """{case: (the training steps' feeds, the eval run's feed)} of the
    global batch; a forward-only case runs its one feed."""
    rng = np.random.RandomState(seed)

    def img(name, lname, classes=5):
        return {name: rng.randn(B, 3, 8, 8).astype(np.float32),
                lname: rng.randint(0, classes, (B, 1)).astype(np.int64)}

    out = {}
    for case in BN_CASES:
        out[case] = ([img("img", "label") for _ in range(STEPS)],
                     img("img", "label"))
    out["channel_split"] = ([img("cimg", "clabel") for _ in range(STEPS)],
                            img("cimg", "clabel"))
    inf = np.ones((B, 3), np.float32)
    inf[B - 3, 1] = np.inf  # in the second rank's rows only
    out["managed"] = ([], {
        "rx": (1.0 + 0.05 * rng.randn(B, 6, 4)).astype(np.float32),
        "rz": inf, "ax": rng.randn(B, 8).astype(np.float32),
        "ay": rng.randint(0, 10, (B, 1)).astype(np.int64)})
    ids = rng.randint(0, 20, (B, 1)).astype(np.int64)
    ids[::5] = 3  # the padding id, in both ranks' rows
    out["lookup"] = ([{"ids": ids, "ly": rng.randn(B, 1).astype(np.float32)}
                      for _ in range(STEPS)], None)
    out["metrics"] = ([], img("mimg", "mlabel", classes=2))
    return out


def _local(feed, index, n):
    b = B // n
    return {k: v[index * b:(index + 1) * b] for k, v in feed.items()}


def _run_case(exe, main, fetch, test, feeds, rank=0, n=1):
    """The training steps' fetches, then the eval run's (on the clone,
    or on main when the case has no optimizer)."""
    steps, last = feeds
    runs = [exe.run(main, feed=_local(f, rank, n), fetch_list=fetch)
            for f in steps]
    if last is not None:
        runs.append(exe.run(test or main, feed=_local(last, rank, n),
                            fetch_list=fetch))
    return [[np.asarray(v) for v in r] for r in runs]


# --- the port's ranks ----------------------------------------------------

def _eval_worker(rank, world, snaps, feeds):
    from paddle_tpu_torch import fluid, parallel

    mesh = parallel.make_mesh({"data": world}, device="cpu")
    out = {}
    for case, build in BUILDS.items():
        main, startup = fluid.Program(), fluid.Program()
        # a case that fails fails its own tests (both ranks fail alike)
        try:
            with fluid.program_guard(main, startup), \
                    fluid.scope_guard(fluid.Scope()):
                fetch, test = build(fluid)
                exe = fluid.Executor(mesh=mesh)
                load_snapshot(fluid, main, fluid.global_scope(),
                              snaps[case])
                exe._run_counter = 1
                runs = _run_case(exe, main, fetch, test, feeds[case], rank,
                                 world)
                out[case] = dict(runs=runs, weights=snapshot(
                    main, fluid.scope_to_numpy(
                        fluid.global_scope()).__getitem__))
        except Exception:
            out[case] = dict(error=traceback.format_exc())
    return out


# --- the JAX mesh --------------------------------------------------------

def _jax_case(JF, build, mesh):
    """(the weights after startup, run(feeds)) of one program on the JAX
    mesh; the ranks start from the snapshot while the JAX side runs."""
    main, startup, scope = JF.Program(), JF.Program(), JF.Scope()
    with JF.program_guard(main, startup), JF.scope_guard(scope):
        fetch, test = build(JF)
        exe = JF.Executor(mesh=mesh)
        exe.run(startup)
        snap = snapshot(main, scope.get)

    def run(feeds):
        with JF.scope_guard(scope):
            runs = _run_case(exe, main, fetch, test, feeds)
        return dict(runs=runs, weights=snapshot(
            main, lambda n: np.asarray(scope.get(n))))

    return snap, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "mesh_eval_2",
                lambda: _two_rank_runs(tmp_path_factory))


def _two_rank_runs(tmp_path_factory):
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    feeds = _feeds(7)
    mesh = jp.make_mesh({"data": 2})
    cases = {c: _jax_case(JF, b, mesh) for c, b in BUILDS.items()}
    tmp = tmp_path_factory.mktemp("eval2")
    procs = start(_eval_worker, 2, tmp, {c: s for c, (s, _) in cases.items()},
                  feeds)
    meshed = {c: run(feeds[c]) for c, (_, run) in cases.items()}
    return dict(meshed=meshed, ports=collect(procs, tmp))


def _close(got, want, what, atol=ATOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                                   err_msg=what)


def _port(runs, rank, case):
    got = runs["ports"][rank][case]
    assert "error" not in got, got.get("error")
    return got


def _held(runs, case, fetches=None, weights=(), weight_atol=ATOL):
    """Every rank's fetches (those at positions `fetches`, else all) in
    every run, and the weights at positions `weights` (all for True),
    against the JAX mesh's."""
    want = runs["meshed"][case]
    for rank in range(len(runs["ports"])):
        got = _port(runs, rank, case)
        assert len(got["runs"]) == len(want["runs"])
        for step, (p, m) in enumerate(zip(got["runs"], want["runs"])):
            assert len(p) == len(m)
            for k in range(len(p)) if fetches is None else fetches:
                _close(p[k], m[k], "%s rank %d run %d fetch %d"
                       % (case, rank, step, k))
        mesh_w = dict(want["weights"])
        assert len(got["weights"]) == len(mesh_w)
        for pos, w in got["weights"]:
            if weights is True or pos in weights:
                _close(w, mesh_w[pos], "%s rank %d weight %d"
                       % (case, rank, pos), weight_atol)


@pytest.mark.parametrize("case", BN_CASES)
def test_batch_norm_in_eval_mode_fetches_the_global_batch(runs, case):
    # pred is [global batch, 5] on every rank, in every training step and
    # in the eval run; the loss and accuracy are the global batch's
    for rank in range(2):
        for r in _port(runs, rank, case)["runs"]:
            assert r[0].shape == (B, 5)
    # then every parameter, running statistic and momentum
    _held(runs, case, weights=True, weight_atol=CANCEL_ATOL)


@pytest.mark.parametrize("run", ("train", "eval"))
def test_batch_norm_over_a_channel_split_reads_it_whole(runs, run):
    """pred and the loss in each training step (then every parameter) or
    in the eval run; the normalised value is whole on every rank, [C,
    global batch, H, W]."""
    want = runs["meshed"]["channel_split"]["runs"]
    picked = range(STEPS) if run == "train" else (STEPS,)
    for rank in range(2):
        got = _port(runs, rank, "channel_split")["runs"]
        for i in picked:
            what = "rank %d run %d" % (rank, i)
            _close(got[i][0], want[i][0], what + " pred")
            _close(got[i][1], want[i][1], what + " loss")
            assert got[i][2].shape == (4, B, 8, 8)
            _close(got[i][2], want[i][2], what + " normalised",
                   CANCEL_ATOL)
    if run == "train":
        _held(runs, "channel_split", fetches=(), weights=True)


MANAGED = [_reduce_id(*r) for r in REDUCES] + list(NORMS) + [
    "accuracy k %d" % k for k in (1, 5)]


@pytest.mark.parametrize("i", range(len(MANAGED)), ids=MANAGED)
def test_a_managed_op_matches_the_jax_mesh(runs, i):
    _held(runs, "managed", fetches=(i,))


@pytest.mark.parametrize("i", range(len(LOOKUPS)), ids=LOOKUPS)
def test_lookup_table_trains_like_the_jax_mesh(runs, i):
    # its rows [global batch, 6] in every step, then its table
    for rank in range(2):
        for r in _port(runs, rank, "lookup")["runs"]:
            assert r[i].shape == (B, 6)
    main_vars = runs["meshed"]["lookup"]["weights"]
    table = [pos for pos, w in main_vars if w.shape == (20, 6)][i]
    _held(runs, "lookup", fetches=(i, len(LOOKUPS)), weights=(table,))


@pytest.mark.parametrize("i", range(len(METRICS)), ids=METRICS)
def test_a_metric_after_eval_batch_norm_matches_the_jax_mesh(runs, i):
    _held(runs, "metrics", fetches=(i,))



# (layout, split dim of X [2, 4, 3, 3]): a batch or spatial split, which
# the kernel's all-reduce of the per-channel sums handles (the channel
# splits, read whole, are cases of test_torch_mesh_global.py's MIXING)
BN_KEPT = [("NCHW", 0), ("NCHW", 2), ("NHWC", 0), ("NHWC", 2)]


@pytest.mark.parametrize("layout,dim", BN_KEPT,
                         ids=["%s dim %d" % s for s in BN_KEPT])
def test_batch_norm_keeps_a_batch_or_spatial_split(layout, dim):
    from test_torch_mesh_global import _Op, _globalized

    spmd = _globalized(_Op("batch_norm", {"X": ["s_x"]},
                           {"data_layout": layout}), dim, (2, 4, 3, 3))
    assert spmd.split_of("s_x") is not None and "s_x" not in spmd.gathered
