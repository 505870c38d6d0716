"""The port's mesh over torch.distributed (paddle_tpu_torch/parallel/
mesh.py, collectives.py, embedding.py): layouts and groups against the
JAX package's make_mesh / make_hybrid_mesh on the conftest's virtual
devices, the collectives and their adjoints, the FSDP dimension choice,
the shard_reader guard and the world of one process. The ranks are CPU
processes in one gloo group (tests/torch_mesh.py); jax stays in the
pytest process."""

import types

import numpy as np
import pytest
import torch

from torch_mesh import spawn


def _layout_worker(rank, world):
    import torch.distributed as dist

    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.parallel import collectives as C

    out = {}
    mesh = parallel.make_mesh({"data": 2, "model": 2}, device="cpu")
    out["devices"] = mesh.devices.tolist()
    out["coords"] = mesh.coords
    # the sum of the ranks over each group names its members
    r = torch.tensor([float(rank)])
    out["sum_data"] = float(C.all_reduce(r, mesh.group("data")))
    out["sum_model"] = float(C.all_reduce(r, mesh.group("model")))
    out["sum_all"] = float(C.all_reduce(r, mesh.group(("data", "model"))))
    hyb = parallel.make_hybrid_mesh({"dcn": 2}, {"data": 2}, device="cpu")
    out["hybrid"] = hyb.devices.tolist()
    out["hybrid_names"] = hyb.axis_names
    out["dp_axes"] = parallel.data_parallel_axes(hyb)
    out["dp_axes_tp"] = parallel.data_parallel_axes(mesh)
    out["spans"] = parallel.spans_processes(mesh)
    for axes in ({"data": 8}, {"dcn": 4, "data": 2}):
        try:
            if "dcn" in axes:
                parallel.make_hybrid_mesh({"dcn": 4}, {"data": 2},
                                          device="cpu")
            else:
                parallel.make_mesh(axes, device="cpu")
            out.setdefault("overcommit", []).append(None)
        except ValueError as e:
            out.setdefault("overcommit", []).append(str(e))

    # all-gather in group order, reduce-scatter, and their adjoints
    g, i = mesh.group("data"), mesh.index("data")
    x = torch.arange(3.0) + 10 * rank
    out["gather"] = C.all_gather(x, 0, g, i, 2).tolist()
    y = torch.arange(4.0) * (rank + 1)
    out["scatter"] = C.reduce_scatter(y, 0, g, i, 2).tolist()
    xl = x.clone().requires_grad_(True)
    full = C.all_gather(xl, 0, g, i, 2)
    (full * torch.arange(6.0)).sum().backward()
    out["gather_grad"] = xl.grad.tolist()
    yl = y.clone().requires_grad_(True)
    (C.reduce_scatter(yl, 0, g, i, 2) * (1.0 + rank)).sum().backward()
    out["scatter_grad"] = yl.grad.tolist()

    # bucketed gradient sync: a few flat buckets, one dtype each
    stats = C.SyncStats()
    grads = {"a": torch.full((3,), 1.0 + rank), "b": torch.ones(2, 2),
             "c": torch.full((5,), float(rank), dtype=torch.float64)}
    synced = C.sync_gradients(grads, mesh.group(("data", "model")), stats,
                              bucket_bytes=16)
    out["synced"] = {k: v.tolist() for k, v in synced.items()}
    out["stats"] = dict(calls=stats.calls, buckets=stats.buckets,
                        bytes=stats.bytes)

    # the row-sharded lookup: 8 rows split over 'model'
    table = torch.arange(16.0).reshape(8, 2)
    m = mesh.index("model")
    shard = table[m * 4:(m + 1) * 4].clone().requires_grad_(True)
    ids = torch.tensor([[1], [6], [9], [3]])
    got = parallel.sharded_lookup(shard, ids, mesh, "model")
    got.sum().backward()
    out["lookup"] = got.tolist()
    out["lookup_grad"] = shard.grad.tolist()

    # shard_reader: disjoint round-robin halves, divergence detected
    ctx = parallel.DistributedContext(mesh)
    items = list(ctx.shard_reader(lambda: iter(range(16)),
                                  verify_every=2)())
    out["reader"] = items
    seed = 7 + rank

    def diverging():
        rng = np.random.RandomState(seed)
        return iter(rng.permutation(16).tolist())

    try:
        list(ctx.shard_reader(diverging, verify_every=2)())
        out["diverged"] = None
    except RuntimeError as e:
        out["diverged"] = str(e)
    dist.barrier()
    return out


def test_mesh_layout_groups_and_collectives(tmp_path):
    import jax

    from paddle_tpu import parallel as jpar

    outs = spawn(_layout_worker, 4, tmp_path)
    # the JAX package lays device ids out the same way
    jm = jpar.make_mesh({"data": 2, "model": 2})
    jh = jpar.make_hybrid_mesh({"dcn": 2}, {"data": 2},
                               devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)
    for rank, o in enumerate(outs):
        assert o["devices"] == ids(jm.devices).tolist() == [[0, 1], [2, 3]]
        assert o["coords"] == {"data": rank // 2, "model": rank % 2}
        assert o["hybrid"] == ids(jh.devices).tolist()
        assert o["hybrid_names"] == jh.axis_names == ("dcn", "data")
        assert o["dp_axes"] == (("dcn", "data"), 4)
        assert o["dp_axes_tp"] == (("data",), 2)
        assert o["spans"]
        # data group {r, r ^ 2}, model group {r, r ^ 1}
        assert o["sum_data"] == rank + (rank ^ 2)
        assert o["sum_model"] == rank + (rank ^ 1)
        assert o["sum_all"] == 6
        assert all("devices" in e for e in o["overcommit"])
        d = rank // 2
        other = 1 - d
        blocks = {d: [10 * rank + k for k in range(3)],
                  other: [10 * (rank ^ 2) + k for k in range(3)]}
        assert o["gather"] == blocks[0] + blocks[1]
        assert o["gather_grad"] == [2.0 * (3 * d + k) for k in range(3)]
        s = (rank + 1) + ((rank ^ 2) + 1)
        assert o["scatter"] == [s * k for k in range(2 * d, 2 * d + 2)]
        # d(sum_j w_j * rs_j)/dy: every rank's weight (1 + rank) summed
        # over the group, laid at that rank's block
        w = {d: 1.0 + rank, other: 1.0 + (rank ^ 2)}
        assert o["scatter_grad"] == [w[0]] * 2 + [w[1]] * 2
        assert o["synced"] == {"a": [10.0] * 3, "b": [[4.0] * 2] * 2,
                               "c": [6.0] * 5}
        # "a" (12 bytes) and "b" (16 bytes) cannot share a 16-byte bucket
        assert o["stats"] == {"calls": 1, "buckets": 3, "bytes": 68}
        table = np.arange(16.0).reshape(8, 2)
        np.testing.assert_array_equal(
            o["lookup"], [[table[1]], [table[6]], [[0.0, 0.0]], [table[3]]])
        m = rank % 2
        # the summed upstream gradient of both model ranks (2 each), on
        # this rank's rows only
        grad = np.zeros((4, 2))
        for row in (1, 6, 3):
            if m * 4 <= row < m * 4 + 4:
                grad[row - m * 4] += 2.0
        np.testing.assert_array_equal(o["lookup_grad"], grad)
        assert o["diverged"] and "divergence" in o["diverged"]
    halves = [set(o["reader"]) for o in outs]
    assert halves[0] | halves[1] | halves[2] | halves[3] == set(range(16))
    assert sum(len(h) for h in halves) == 16


def _world_of_one_worker(rank, world):
    import torch.distributed as dist

    from paddle_tpu_torch import parallel

    out = {"before": dist.is_initialized()}
    try:
        parallel.make_mesh({"data": 2}, device="cpu")
    except ValueError as e:
        out["two"] = str(e)
    mesh = parallel.make_mesh(None, device="cpu", backend="gloo")
    out["after"] = dist.is_initialized()
    out["world"] = dist.get_world_size()
    out["shape"] = dict(mesh.shape)
    # a world of one: the world group itself, a one-rank sum
    out["group_is_world"] = mesh.group("data") is dist.group.WORLD
    out["backend"] = mesh.backend
    return out


def test_world_of_one_needs_no_launcher(tmp_path):
    (o,) = spawn(_world_of_one_worker, 1, tmp_path, init=False)
    assert o["before"] is False and o["after"] is True
    assert "mesh needs 2 devices" in o["two"]
    assert o["world"] == 1 and o["shape"] == {"data": 1}
    assert o["group_is_world"]
    assert o["backend"] == "gloo"  # the CPU's backend


def test_fsdp_picks_the_jax_dimensions():
    """shard_parameters_fsdp is a pure function of shapes: the port picks
    the same dimension of every parameter as the JAX package."""
    import paddle_tpu.fluid as JF
    from paddle_tpu import parallel as jpar
    from paddle_tpu_torch import fluid as TF
    from paddle_tpu_torch import parallel as tpar

    def build(fluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data(name="x", shape=[12], dtype="float32")
            h = fluid.layers.fc(input=x, size=64)
            h = fluid.layers.fc(input=h, size=40)
            h = fluid.layers.fc(input=h, size=6)
            fluid.layers.embedding(
                input=fluid.layers.data(name="i", shape=[1], dtype="int64"),
                size=[100, 24])
        return main

    for n in (2, 4, 8):
        jm, tm = build(JF), build(TF)
        mesh = types.SimpleNamespace(shape={"data": n})
        jd = jpar.shard_parameters_fsdp(jm, mesh, min_size=64)
        td = tpar.shard_parameters_fsdp(tm, mesh, min_size=64)
        assert len(jd) == len(td) > 0
        pos = {v.name: i for i, v in enumerate(
            jm.global_block().all_parameters())}
        tpos = {v.name: i for i, v in enumerate(
            tm.global_block().all_parameters())}
        jspecs = sorted((pos[k], tuple(v)) for k, v in jm.shardings.items())
        tspecs = sorted((tpos[k], tuple(v))
                        for k, v in tm.shardings.items())
        assert jspecs == tspecs


def test_partition_spec_round_trips_through_a_saved_program():
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.fluid.core import serialization
    from paddle_tpu_torch.parallel.mesh import P, shard_parameter

    main = fluid.Program()
    with fluid.program_guard(main, fluid.Program()):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        fluid.layers.fc(input=x, size=8,
                        param_attr=fluid.ParamAttr(name="w_spec"))
    shard_parameter(main.global_block().var("w_spec"),
                    P(None, ("dcn", "model")))
    back = serialization.program_from_dict(
        serialization.program_to_dict(main))
    assert back.shardings["w_spec"] == P(None, ("dcn", "model"))
    assert isinstance(back.shardings["w_spec"], P)
