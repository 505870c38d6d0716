"""The global forms of the port's mesh executor (fluid/core/spmd.py)
against the JAX package: ops that mix the batch (concat, a softmax over
it, cumsum, slice, an in-batch two-tower loss), `shape` and
`fill_constant_batch_size_like`, the metrics, a While over a batch-split
value, a random draw split along dimension 1, and specs that split two
dimensions under Adam with their sharded checkpoints. Every case is
held against the JAX package's mesh (the conftest's virtual devices)
and its single-device run on the global batch, from the same weights:
rtol 1e-5 (atol 1e-6) in f32, counts and shapes equal.

The port's ranks run in one module-scoped spawn of two gloo CPU ranks
({data: 2}) and one of four ({data: 2, model: 2}, then {dcn: 2, data:
1, model: 2}), tests/torch_mesh.py; jax stays in the pytest process."""

import glob
import json
import os
import traceback

import numpy as np
import pytest

from torch_mesh import collect, load_snapshot, once, snapshot, start

B = 8  # the global batch of every case
RTOL, ATOL = 1e-5, 1e-6


def _param(fluid, name, seed):
    return fluid.ParamAttr(
        name=name, initializer=fluid.initializer.Normal(scale=0.5,
                                                        seed=seed))


def _raw(fluid, op_type, x, dtype, slot="X"):
    """An op with no layer function: one input, one output."""
    helper = fluid.layer_helper.LayerHelper(op_type)
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type=op_type, inputs={slot: [x]},
                     outputs={"Out": [out]}, attrs={})
    return out


# --- the programs both packages build ------------------------------------

def mixing(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[4], dtype="float32")
    both = L.concat([x, x], axis=0)
    over_batch = L.softmax(L.transpose(x, perm=[1, 0]))
    return [L.reduce_sum(both), both, over_batch, L.cumsum(x, axis=0),
            L.slice(x, axes=[0], starts=[1], ends=[6])]


def two_tower(fluid):
    L = fluid.layers
    qa = L.data(name="qa", shape=[6], dtype="float32")
    qb = L.data(name="qb", shape=[6], dtype="float32")
    row = L.data(name="row", shape=[1], dtype="int64")
    a = L.fc(input=qa, size=8, param_attr=_param(fluid, "tw_a", 11),
             bias_attr=False)
    b = L.fc(input=qb, size=8, param_attr=_param(fluid, "tw_b", 12),
             bias_attr=False)
    # each row's positive is its own partner; the batch's other rows
    # are its negatives
    prob = L.softmax(L.matmul(a, b, transpose_y=True))
    loss = L.mean(L.cross_entropy(input=prob, label=row))
    fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
    return [loss, "tw_a@GRAD", "tw_b@GRAD"]


def shapes(fluid):
    L = fluid.layers
    x = L.data(name="sx", shape=[5], dtype="float32")
    other = L.fill_constant_batch_size_like(
        input=x, shape=[-1, 2], dtype="float32", value=1.5,
        input_dim_idx=1, output_dim_idx=0)
    rows = L.fill_constant_batch_size_like(
        input=x, shape=[-1, 3], dtype="float32", value=2.0)
    return [_raw(fluid, "shape", x, "int32", "Input"), other, rows,
            L.reduce_sum(rows)]


def metrics(fluid):
    L = fluid.layers
    x = L.data(name="mx", shape=[5], dtype="float32")
    y = L.data(name="my", shape=[1], dtype="int64")
    pred = L.fc(input=x, size=3, act="softmax",
                param_attr=_param(fluid, "mt_w", 13))
    _, idx = L.topk(pred, k=1)
    batch, accum, states = L.precision_recall(input=idx, label=y,
                                              class_number=3)
    # an inf in one rank's rows only: the flag is the global batch's
    z = L.data(name="mz", shape=[3], dtype="float32")
    return [batch, accum, states, _raw(fluid, "isfinite", z, "bool"),
            _raw(fluid, "isfinite", x, "bool"),
            _raw(fluid, "is_empty", x, "bool")]


def while_net(fluid):
    L = fluid.layers
    x = L.data(name="wx", shape=[4], dtype="float32")
    h = L.fc(input=x, size=4, param_attr=_param(fluid, "wl_w", 14))
    lim = L.fill_constant(shape=[1], dtype="int64", value=3)
    i = L.zeros(shape=[1], dtype="int64", force_cpu=True)
    arr = L.create_array("float32")
    L.array_write(h, i=i, array=arr)
    cond = L.less_than(x=i, y=lim)
    loop = L.While(cond=cond)
    with loop.block():
        prev = L.array_read(array=arr, i=i)
        nxt = L.elementwise_add(x=prev, y=L.scale(x=h, scale=0.5))
        L.increment(x=i, value=1, in_place=True)
        L.array_write(nxt, i=i, array=arr)
        L.less_than(x=i, y=lim, cond=cond)
    final = L.array_read(array=arr, i=lim)
    loss = L.mean(L.square(final))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss, final]


def draw(fluid):
    L = fluid.layers
    x = L.data(name="dx", shape=[6], dtype="float32")
    return [L.dropout(L.transpose(x, perm=[1, 0]), dropout_prob=0.5)]


def spec_net(fluid, shard):
    L = fluid.layers
    x = L.data(name="px", shape=[8], dtype="float32")
    y = L.data(name="py", shape=[1], dtype="float32")
    h = L.fc(input=x, size=6, act="tanh",
             param_attr=_param(fluid, "sp_w", 15), bias_attr=False)
    pred = L.fc(input=h, size=1, param_attr=_param(fluid, "sp_o", 16),
                bias_attr=fluid.ParamAttr(
                    name="sp_b", initializer=fluid.initializer.Constant(0.1)))
    loss = L.mean(L.square_error_cost(input=pred, label=y))
    shard(fluid.default_main_program().global_block().var("sp_w"))
    fluid.optimizer.Adam(learning_rate=0.05).minimize(loss)
    return [loss]


def _feeds(seed, steps):
    rng = np.random.RandomState(seed)
    return {
        "mixing": [{"x": rng.randn(B, 4).astype(np.float32)}],
        "two_tower": [{"qa": rng.randn(B, 6).astype(np.float32),
                       "qb": rng.randn(B, 6).astype(np.float32),
                       "row": np.arange(B, dtype=np.int64)[:, None]}
                      for _ in range(steps)],
        "shapes": [{"sx": rng.randn(B, 5).astype(np.float32)}],
        "metrics": [{"mx": rng.randn(B, 5).astype(np.float32),
                     "my": rng.randint(0, 3, (B, 1)).astype(np.int64),
                     "mz": np.where(np.arange(B * 3).reshape(B, 3) == 19,
                                    np.inf, 1.0).astype(np.float32)}],
        "while": [{"wx": rng.randn(B, 4).astype(np.float32)}
                  for _ in range(steps)],
        "draw": [{"dx": rng.randn(B, 6).astype(np.float32)}],
        "spec": [{"px": rng.randn(B, 8).astype(np.float32),
                  "py": rng.randn(B, 1).astype(np.float32)}
                 for _ in range(steps)],
    }


STEPS = 3
BUILDS = {"mixing": mixing, "two_tower": two_tower, "shapes": shapes,
          "metrics": metrics, "while": while_net, "draw": draw}
TRAINED = ("two_tower", "while")
# the 2-D specs, each on its 4-rank mesh
SPEC_PARAMS = ("sp_w", "sp_o", "sp_b")
SPECS = {"data_model": ({"data": 2, "model": 2}, ("data", "model")),
         "model_dcn_data": ({"dcn": 2, "data": 1, "model": 2},
                            ("model", ("dcn", "data")))}


def _local(feed, index, n):
    b = B // n
    return {k: v[index * b:(index + 1) * b] for k, v in feed.items()}


def _weights(fluid, main):
    return snapshot(main, fluid.scope_to_numpy(
        fluid.global_scope()).__getitem__)


# --- the port's ranks ----------------------------------------------------

def _two_rank_worker(rank, world, snaps, feeds):
    from paddle_tpu_torch import fluid, parallel

    mesh = parallel.make_mesh({"data": world}, device="cpu")
    out = {}
    for case, build in BUILDS.items():
        main, startup = fluid.Program(), fluid.Program()
        # a case that fails fails its own test (both ranks fail alike)
        try:
            with fluid.program_guard(main, startup), \
                    fluid.scope_guard(fluid.Scope()):
                fetch = build(fluid)
                exe = fluid.Executor(mesh=mesh)
                load_snapshot(fluid, main, fluid.global_scope(),
                              snaps[case])
                exe._run_counter = 1
                runs = [exe.run(main, feed=_local(f, rank, world),
                                fetch_list=fetch) for f in feeds[case]]
                out[case] = dict(runs=runs, weights=_weights(fluid, main))
        except Exception:
            out[case] = dict(error=traceback.format_exc())
    return out


def _four_rank_worker(rank, world, snap, feeds, ckpt_dir):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.parallel.mesh import P, data_parallel_axes

    out = {}
    for key, (axes, spec) in SPECS.items():
        mesh = parallel.make_mesh(axes, device="cpu")
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(fluid.Scope()):
            fetch = spec_net(fluid, lambda v: parallel.shard_parameter(
                v, P(*spec)))
            exe = fluid.Executor(mesh=mesh)
            load_snapshot(fluid, main, fluid.global_scope(), snap)
            exe._run_counter = 1
            data_axes, n = data_parallel_axes(mesh)
            i = mesh.index(data_axes)
            runs = [exe.run(main, feed=_local(f, i, n), fetch_list=fetch)
                    for f in feeds["spec"]]
            scope = fluid.global_scope()
            out[key] = dict(
                runs=runs, weights=_weights(fluid, main),
                named={k: fluid.fetch_var(k) for k in SPEC_PARAMS},
                here={k: tuple(scope.get(k).shape) for k in scope.keys()
                      if hasattr(scope.get(k), "shape")})
            if key == "data_model":
                checkpoint.save_checkpoint(scope, ckpt_dir, step=STEPS)
    return out


# --- the JAX side --------------------------------------------------------

def _jax_case(JF, build, mesh=None):
    """(the weights after startup, run(feeds)) of one program in the JAX
    package: one device, or the JAX mesh `mesh`. The ranks start from the
    snapshot while the JAX side runs."""
    main, startup, scope = JF.Program(), JF.Program(), JF.Scope()
    with JF.program_guard(main, startup), JF.scope_guard(scope):
        fetch = build(JF)
        exe = JF.Executor(JF.CPUPlace()) if mesh is None \
            else JF.Executor(mesh=mesh)
        exe.run(startup)
        snap = snapshot(main, scope.get)

    def run(feeds, ckpt_dir=None):
        from paddle_tpu.distributed import checkpoint

        with JF.scope_guard(scope):
            runs = [[np.asarray(v) for v in exe.run(main, feed=f,
                                                     fetch_list=fetch)]
                    for f in feeds]
            if ckpt_dir is not None:
                checkpoint.save_checkpoint(scope, ckpt_dir, step=STEPS)
        return dict(
            runs=runs,
            weights=snapshot(main, lambda n: np.asarray(scope.get(n))),
            named={k: np.asarray(scope.get(k)) for k in SPEC_PARAMS
                   if k in scope},
            spec=tuple(getattr(getattr(scope.get("sp_w"), "sharding",
                                       None), "spec", ()))
            if "sp_w" in scope else ())

    return snap, run


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once(tmp_path_factory, "mesh_global_2",
                lambda: _two_rank_runs(tmp_path_factory))


def _two_rank_runs(tmp_path_factory):
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    feeds = _feeds(5, STEPS)
    mesh = jp.make_mesh({"data": 2})
    single = {c: _jax_case(JF, b) for c, b in BUILDS.items()}
    meshed = {c: _jax_case(JF, b, mesh) for c, b in BUILDS.items()}
    tmp = tmp_path_factory.mktemp("global2")
    procs = start(_two_rank_worker, 2, tmp,
                  {c: single[c][0] for c in BUILDS}, feeds)
    single = {c: single[c][1](feeds[c]) for c in BUILDS}
    meshed = {c: meshed[c][1](feeds[c]) for c in BUILDS}
    return dict(single=single, meshed=meshed, ports=collect(procs, tmp))


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if got.dtype.kind in "biu" or want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("case", list(BUILDS))
def test_global_form_matches_the_jax_mesh_and_one_device(runs, case):
    single, meshed = runs["single"][case], runs["meshed"][case]
    for rank, port in enumerate(runs["ports"]):
        got = port[case]
        assert "error" not in got, got.get("error")
        assert len(got["runs"]) == len(single["runs"])
        for step, (p, s, m) in enumerate(zip(got["runs"], single["runs"],
                                             meshed["runs"])):
            assert len(p) == len(s) == len(m)
            for k, (pv, sv, mv) in enumerate(zip(p, s, m)):
                what = "%s rank %d step %d fetch %d" % (case, rank, step, k)
                _close(pv, sv, what + " vs one device")
                _close(pv, mv, what + " vs the JAX mesh")
        if case in TRAINED:
            want = dict(single["weights"])
            for pos, w in got["weights"]:
                _close(w, want[pos], "%s weight %d" % (case, pos))


# --- specs that split two dimensions -------------------------------------

def _noop(v):
    return v


@pytest.fixture(scope="module")
def specs(tmp_path_factory):
    return once(tmp_path_factory, "mesh_global_4",
                lambda: _four_rank_runs(tmp_path_factory))


def _four_rank_runs(tmp_path_factory):
    import jax.sharding
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jp

    feeds = _feeds(5, STEPS)["spec"]
    tmp = tmp_path_factory.mktemp("global4")
    snap, single = _jax_case(JF, lambda f: spec_net(f, _noop))
    meshed = {key: _jax_case(JF, lambda f, spec=spec: spec_net(
        f, lambda v: jp.shard_parameter(
            v, jax.sharding.PartitionSpec(*spec))), jp.make_mesh(axes))[1]
        for key, (axes, spec) in SPECS.items()}
    procs = start(_four_rank_worker, 4, tmp, snap, {"spec": feeds},
                  str(tmp / "port_ckpt"))
    single = single(feeds)
    meshed = {key: run(feeds, str(tmp / "jax_ckpt")
                       if key == "data_model" else None)
              for key, run in meshed.items()}
    return dict(single=single, meshed=meshed, ports=collect(procs, tmp),
                tmp=tmp)


@pytest.mark.parametrize("key", list(SPECS))
def test_two_dimension_spec_trains_like_the_jax_mesh(specs, key):
    single, meshed = specs["single"], specs["meshed"][key]
    spec = SPECS[key][1]
    assert meshed["spec"] == spec  # the JAX mesh keeps the 2-D spec
    for rank, port in enumerate(specs["ports"]):
        got = port[key]
        assert got["here"]["sp_w"] == (4, 3)  # a quarter on each rank
        for step, (p, s, m) in enumerate(zip(got["runs"], single["runs"],
                                             meshed["runs"])):
            _close(p[0], s[0], "%s rank %d loss %d" % (key, rank, step))
            _close(p[0], m[0], "%s rank %d loss %d" % (key, rank, step))
        want, mesh_w = dict(single["weights"]), dict(meshed["weights"])
        assert len(got["weights"]) == len(want)
        for pos, w in got["weights"]:
            _close(w, want[pos], "%s weight %d" % (key, pos))
            _close(w, mesh_w[pos], "%s weight %d (JAX mesh)" % (key, pos))
        # the Adam moments of sp_w are held as 2-D blocks too
        assert sum(1 for n, s in got["here"].items()
                   if s == (4, 3)) >= 3


def test_two_dimension_checkpoints_cross_packages_and_load_4_to_1(specs):
    import paddle_tpu.fluid as JF
    from paddle_tpu.distributed import checkpoint as jckpt
    from paddle_tpu_torch import fluid as TF
    from paddle_tpu_torch.distributed import checkpoint as tckpt

    tmp = specs["tmp"]
    port_w = specs["ports"][0]["data_model"]["named"]
    # each of the 4 ranks wrote its own block of sp_w, placed along both
    # dimensions
    step_dir = os.path.join(str(tmp / "port_ckpt"), "step_%010d" % STEPS)
    blocks = []
    for meta in glob.glob(os.path.join(step_dir, "checkpoint.meta.p*.json")):
        with open(meta) as f:
            ent = json.load(f)["entries"].get("sp_w")
        if ent is not None:
            blocks += [tuple(map(tuple, sh["index"])) for sh in ent["shards"]]
    assert sorted(blocks) == [((0, 4), (0, 3)), ((0, 4), (3, 6)),
                              ((4, 8), (0, 3)), ((4, 8), (3, 6))]
    # the port's 4-rank checkpoint: its 2-D blocks merged in the JAX
    # package and in one port process (4 -> 1); the JAX mesh's
    # checkpoint of the same run, in the port
    for load, scope, ckpt, want in (
            (jckpt.load_checkpoint, JF.Scope(), "port_ckpt", port_w),
            (tckpt.load_checkpoint, TF.Scope(), "port_ckpt", port_w),
            (tckpt.load_checkpoint, TF.Scope(), "jax_ckpt",
             specs["meshed"]["data_model"]["named"])):
        meta = load(scope, str(tmp / ckpt))
        assert meta["step"] == STEPS
        for name in SPEC_PARAMS:
            _close(np.asarray(scope.get(name), dtype=np.float32),
                   want[name], "%s %s" % (ckpt, name))
    for name in SPEC_PARAMS:
        _close(port_w[name], specs["meshed"]["data_model"]["named"][name],
               name)


# --- every former refusal reads its split inputs whole --------------------

# the ops the mesh executor refused on a split input before its global
# forms (those whose kernel now computes one stay split)
FORMER_REFUSALS = (
    "chunk_eval", "precision_recall", "edit_distance", "detection_map",
    "pnpair_eval", "lambda_rank", "ctc_align", "warpctc",
    "linear_chain_crf", "crf_decoding", "multiclass_nms",
    "ssd_multibox_loss", "bipartite_match", "prior_box", "box_coder",
    "roi_pool", "scatter", "shape", "is_empty", "isfinite", "im2sequence",
    "row_conv", "lod_reset", "lod_rank_table", "max_sequence_len",
    "reorder_lod_tensor_by_rank", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_rnn_memory", "split_lod_tensor",
    "merge_lod_tensor", "beam_search", "beam_search_decode", "beam_init",
    "while", "dynamic_rnn", "array_write", "array_read", "array_length",
    "lstm", "gru", "lstmp", "sub_nested_seq", "kmax_seq_score",
    "cross_entropy_over_beam", "crop", "sequence_pool", "sequence_concat",
    "sequence_context", "sequence_conv", "sequence_erase",
    "sequence_expand", "sequence_mask", "sequence_reshape",
    "sequence_reverse", "sequence_slice", "sequence_softmax")
GLOBAL_KERNELS = ("shape", "is_empty", "isfinite", "precision_recall")
# (op, attrs, split input slots, split dim) of each true case of the
# mixing table
MIXING = [
    ("concat", {"axis": 0}, ("X",)), ("split", {"axis": 0}, ("X",)),
    ("slice", {"axes": [0]}, ("Input",)), ("cumsum", {"axis": 0}, ("X",)),
    ("reverse", {"axis": [0]}, ("X",)), ("softmax", {"axis": 0}, ("X",)),
    ("log_softmax", {"axis": 0}, ("X",)),
    ("l2_normalize", {"axis": 0}, ("X",)), ("norm", {"axis": 0}, ("X",)),
    ("layer_norm", {"begin_norm_axis": 0}, ("X",)),
    ("pad", {"paddings": [1, 0, 0, 0]}, ("X",)),
    ("expand", {"expand_times": [2, 1]}, ("X",)),
    ("gather", {}, ("X",)), ("mul", {}, ("Y",)), ("matmul", {}, ("Y",)),
    ("squeeze", {"axes": [0]}, ("X",)), ("reshape", {}, ("X",), 1),
    ("sampling_id", {}, ("X",), 1), ("nce", {}, ("Input",), 1),
    ("elementwise_add", {}, ("Y",)), ("elementwise_mul", {}, ("Y",)),
    ("batch_norm", {}, ("X",), 1),
    ("batch_norm", {"data_layout": "NHWC"}, ("X",), 1)]
MIXING = [m if len(m) == 4 else m + (0,) for m in MIXING]


class _Mesh(object):
    """Two data ranks seen from rank 0, with no process group: the
    all-gather returns its block (what is tested is which values the
    executor reads whole)."""
    axis_names = ("data",)
    shape = {"data": 2}
    size = 2

    def extent(self, axes):
        return 2

    def index(self, axes):
        return 0

    def group(self, axes):
        return None


class _Op(object):
    def __init__(self, type, inputs, attrs):
        self.type, self.inputs, self.attrs = type, inputs, attrs
        self.outputs = {"Out": ["out"]}
        self.input_arg_names = [n for ns in inputs.values() for n in ns]
        self.output_arg_names = ["out"]


def _globalized(op, split_dim=0, shape=(4, 3)):
    import torch

    from paddle_tpu_torch.fluid.core.spmd import Split, SpmdContext

    spmd = SpmdContext(_Mesh(), {})
    env = {n: torch.ones(shape) for n in op.input_arg_names}
    for slot, names in op.inputs.items():
        if slot in ("X", "Y", "Input") and names[0].startswith("s_"):
            spmd.mark(names[0], Split(split_dim, ("data",)))
    spmd.globalize(op, env, None)
    return spmd


@pytest.mark.parametrize("op_type", FORMER_REFUSALS)
def test_a_former_refusal_reads_its_split_input_whole(op_type):
    op = _Op(op_type, {"X": ["s_x"]}, {})
    spmd = _globalized(op)
    if op_type in GLOBAL_KERNELS:  # its kernel computes the global form
        assert spmd.split_of("s_x") is not None
    else:
        assert spmd.split_of("s_x") is None and "s_x" in spmd.gathered


@pytest.mark.parametrize("op_type,attrs,slots,dim", MIXING,
                         ids=[m[0] for m in MIXING])
def test_a_mixing_case_reads_its_split_input_whole(op_type, attrs, slots,
                                                   dim):
    import torch

    inputs = {"X": ["x"], "Y": ["y"], "Input": ["i"]}
    for slot in slots:
        inputs[slot] = ["s_" + slot.lower()]
    spmd = _globalized(_Op(op_type, inputs, attrs), dim)
    for slot in slots:
        name = "s_" + slot.lower()
        assert spmd.split_of(name) is None and name in spmd.gathered
    # and an op that reads a gathered value beside a split one reads the
    # split one whole too
    spmd.propagate(_Op(op_type, inputs, attrs), {})
    assert "out" in spmd.gathered
    spmd.mark("s_z", spmd.batch)
    spmd.globalize(_Op("elementwise_add", {"X": ["s_z"], "Y": ["out"]},
                       {}), {"s_z": torch.ones(2, 3),
                             "out": torch.ones(4, 3)}, None)
    assert spmd.split_of("s_z") is None
