"""The two multi-process drills of tests/test_multihost.py, on the port:
ranks are gloo CPU processes (tests/torch_mesh.py, a `file://` store, no
TCP port for the group), killed with SIGKILL mid-pass.

- Kill-resume (test_multihost.py:68): two ranks train data-parallel
  with an FSDP-split weight and save a sharded checkpoint every step;
  after step 3 of 6 both are killed, and a fresh single process resumes
  from the merged checkpoint.
- Hybrid elastic (test_multihost.py:359): four ranks on
  make_hybrid_mesh({dcn: 2}, {model: 2}) (a port rank is a process, so
  2 x 2 where the JAX test has 4 x 2 devices), a ragged LSTM with one fc
  weight split over `model` and one weight split over (dcn, model),
  batch slices leased from the port's CoordinatorServer. All ranks are
  killed mid-pass; one process reclaims the leases, restores 4 -> 1 and
  finishes the schedule.

Each is held against the JAX package's single-process run from the same
weights: losses and final weights within rtol 2e-4. The dead ranks'
leases are expired explicitly right after the kill (their deadline set
to now), where the JAX test waits out a 10 s lease: a lease long enough
for a slow rank never expires under it, and the drill waits for
nothing. jax stays in the pytest process: the ranks import the port
alone."""

import json
import os
import time

import numpy as np

from torch_mesh import kill, load_snapshot, snapshot, spawn, start

RTOL = 2e-4
IDLE_S = 300  # a rank waits this long for its kill at most


def _wait_files(paths, procs, timeout=240):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if all(os.path.exists(p) for p in paths):
            return
        dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
        assert not dead, "a rank died before it reported: %s" % dead
        time.sleep(0.05)
    raise AssertionError("ranks never reported: %s" % paths)


def _report(path, result):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(result, f)
    os.replace(tmp, path)


def _idle():
    end = time.time() + IDLE_S
    while time.time() < end:
        time.sleep(0.2)


def _weights(fluid, main):
    return [(i, a.tolist()) for i, a in snapshot(
        main, fluid.scope_to_numpy(fluid.global_scope()).__getitem__)]


# --- kill-resume ----------------------------------------------------------

GLOBAL_BATCH, FEATURES, HIDDEN = 16, 8, 6
BEFORE_KILL, TOTAL = 3, 6


def dense_model(fluid):
    x = fluid.layers.data(name="x", shape=[FEATURES], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(input=x, size=HIDDEN, act="relu")
    pred = fluid.layers.fc(input=h, size=1)
    loss = fluid.layers.mean(
        x=fluid.layers.square_error_cost(input=pred, label=y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return loss


def dense_batch(step, lo=0, hi=GLOBAL_BATCH):
    rng = np.random.RandomState(1234 + step)
    xs = rng.randn(GLOBAL_BATCH, FEATURES).astype(np.float32)
    w = np.linspace(-1, 1, FEATURES, dtype=np.float32).reshape(-1, 1)
    ys = (np.maximum(xs, 0) @ w).astype(np.float32)
    return xs[lo:hi], ys[lo:hi]


def _dist_worker(rank, world, snap, ckpt_dir, report):
    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.parallel.mesh import P

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = dense_model(fluid)
        # FSDP-style: the first weight's rows split over the ranks
        parallel.shard_parameter(main.global_block().var("fc_0.w_0"),
                                 P("data", None))
    exe = fluid.Executor(mesh=parallel.make_mesh({"data": world},
                                                 device="cpu"))
    scope = fluid.global_scope()
    load_snapshot(fluid, main, scope, snap)
    exe._run_counter = 1
    per = GLOBAL_BATCH // world
    losses = []
    for step in range(BEFORE_KILL):
        x, y = dense_batch(step, rank * per, (rank + 1) * per)
        losses.append(float(exe.run(main, feed={"x": x, "y": y},
                                    fetch_list=[loss])[0][0]))
        checkpoint.save_checkpoint(scope, ckpt_dir, step=step)
    _report(report % rank, dict(
        losses=losses, here=list(scope.get("fc_0.w_0").shape)))
    _idle()


def _resume_worker(rank, world, ckpt_dir):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import checkpoint

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = dense_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    meta = checkpoint.load_checkpoint(fluid.global_scope(), ckpt_dir)
    losses = []
    for step in range(meta["step"] + 1, TOTAL):
        x, y = dense_batch(step)
        losses.append(float(exe.run(main, feed={"x": x, "y": y},
                                    fetch_list=[loss])[0][0]))
    return dict(step=meta["step"], losses=losses,
                weights=_weights(fluid, main))


def _jax_oracle(build, batch, steps):
    """(the weights after startup, run()) of the JAX package's
    single-process run of `steps` steps: run() gives its losses and
    final weights. The ranks start from the snapshot while it runs."""
    import paddle_tpu.fluid as JF

    main, startup, scope = JF.Program(), JF.Program(), JF.Scope()
    with JF.program_guard(main, startup), JF.scope_guard(scope):
        loss = build(JF)
        exe = JF.Executor(JF.CPUPlace())
        exe.run(startup)
        snap = snapshot(main, scope.get)

    def run():
        with JF.scope_guard(scope):
            losses = [float(np.ravel(exe.run(
                main, feed=batch(step), fetch_list=[loss])[0])[0])
                for step in range(steps)]
        return losses, dict(snapshot(main, lambda n: np.asarray(
            scope.get(n))))

    return snap, run


def _check_weights(got, want):
    assert len(got) == len(want)
    for pos, w in got:
        np.testing.assert_allclose(np.asarray(w, np.float32), want[pos],
                                   rtol=RTOL, atol=1e-5)


def test_two_rank_kill_resume_matches_the_jax_oracle(tmp_path):
    def batch(step):
        x, y = dense_batch(step)
        return {"x": x, "y": y}

    snap, oracle_run = _jax_oracle(dense_model, batch, TOTAL)
    ckpt_dir = str(tmp_path / "ckpt")
    report = str(tmp_path / "dist_%d.json")
    procs = start(_dist_worker, 2, tmp_path, snap, ckpt_dir, report)
    try:
        oracle, final = oracle_run()
        _wait_files([report % r for r in range(2)], procs)
    finally:
        kill(procs)  # the preemption
    dist = [json.load(open(report % r)) for r in range(2)]
    assert dist[0]["losses"] == dist[1]["losses"]
    assert dist[0]["here"] == [FEATURES // 2, HIDDEN]  # a shard each
    step_dir = os.path.join(ckpt_dir, "step_%010d" % (BEFORE_KILL - 1))
    files = os.listdir(step_dir)
    assert sorted(f for f in files if f.startswith("checkpoint.meta")) == [
        "checkpoint.meta.p0.json", "checkpoint.meta.p1.json"]
    assert any(".p0.s" in f for f in files)
    assert any(".p1.s" in f for f in files)

    (tmp_path / "resume").mkdir()
    (resume,) = spawn(_resume_worker, 1, tmp_path / "resume", ckpt_dir,
                      init=False)
    assert resume["step"] == BEFORE_KILL - 1
    np.testing.assert_allclose(dist[0]["losses"] + resume["losses"],
                               oracle, rtol=RTOL, atol=1e-6)
    _check_weights(resume["weights"], final)


# --- the hybrid elastic drill ---------------------------------------------

VOCAB, N_SEQS, HID, CLASSES = 12, 8, 4, 4
STEPS_A, STEPS = 2, 4
SLICES = [[0, 4], [4, 8]]


def lstm_model(fluid, shard=None):
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    label = fluid.layers.data(name="y", shape=[1], dtype="int64")
    emb = fluid.layers.embedding(input=words, size=[VOCAB, 8])
    proj = fluid.layers.fc(input=emb, size=HID * 4,
                           param_attr=fluid.ParamAttr(name="hy_in"))
    hidden, _ = fluid.layers.dynamic_lstm(input=proj, size=HID * 4)
    last = fluid.layers.sequence_last_step(input=hidden)
    pred = fluid.layers.fc(input=last, size=CLASSES, act="softmax",
                           param_attr=fluid.ParamAttr(name="hy_out"))
    loss = fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=pred, label=label))
    if shard is not None:
        shard(fluid.default_main_program().global_block())
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def lstm_batch(step, lo=0, hi=N_SEQS):
    rng = np.random.RandomState(4242 + step)
    lens = rng.randint(2, 6, N_SEQS)
    seqs = [rng.randint(0, VOCAB, n) for n in lens]
    labels = (np.asarray([s.sum() for s in seqs]) % CLASSES).astype(
        np.int64)
    sel = seqs[lo:hi]
    flat = np.concatenate(sel).reshape(-1, 1).astype(np.int64)
    offsets = np.cumsum([0] + [len(s) for s in sel]).astype(np.int32)
    return {"words": (flat, [offsets]), "y": labels[lo:hi].reshape(-1, 1)}


def _hybrid_worker(rank, world, snap, ckpt_dir, address, report):
    import torch.distributed as dist

    from paddle_tpu_torch import fluid, parallel
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.distributed.coordinator import RemoteCoordinator
    from paddle_tpu_torch.parallel.mesh import P

    mesh = parallel.make_hybrid_mesh({"dcn": 2}, {"model": 2},
                                     device="cpu")

    def shard(block):
        parallel.shard_parameter(block.var("hy_in"), P(None, "model"))
        parallel.shard_parameter(block.var("hy_out"), P("dcn", "model"))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = lstm_model(fluid, shard)
    # one lease per dcn slice: its first rank takes it, and hands it to
    # the other rank of its slice (both feed the slice's batch)
    lease = [None]
    if mesh.coords["model"] == 0:
        task = RemoteCoordinator(address).get_task()
        assert task is not None, "no slice lease available"
        lease = [(task.task_id, list(task.payload))]
    peers = mesh.devices[mesh.coords["dcn"]].tolist()
    dist.broadcast_object_list(lease, src=peers[0],
                               group=mesh.host_group("model"))
    task_id, (lo, hi) = lease[0]
    exe = fluid.Executor(mesh=mesh)
    scope = fluid.global_scope()
    load_snapshot(fluid, main, scope, snap)
    exe._run_counter = 1
    losses = []
    for step in range(STEPS_A):
        losses.append(float(exe.run(main, feed=lstm_batch(step, lo, hi),
                                    fetch_list=[loss])[0][0]))
        checkpoint.save_checkpoint(scope, ckpt_dir, step=step)
    # the lease is not finished: the ranks die holding it
    _report(report % rank, dict(
        losses=losses, task_id=task_id, lo_hi=[lo, hi],
        here={n: list(scope.get(n).shape) for n in ("hy_in", "hy_out")}))
    _idle()


def _hybrid_resume_worker(rank, world, ckpt_dir, address):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.distributed import checkpoint
    from paddle_tpu_torch.distributed.coordinator import RemoteCoordinator

    coord = RemoteCoordinator(address)
    reclaimed = []
    for _ in SLICES:
        task = coord.get_task()
        assert task is not None, "a dead rank's lease was not reclaimed"
        reclaimed.append(task)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = lstm_model(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    meta = checkpoint.load_checkpoint(fluid.global_scope(), ckpt_dir)
    losses = [float(exe.run(main, feed=lstm_batch(step),
                            fetch_list=[loss])[0][0])
              for step in range(meta["step"] + 1, STEPS)]
    for task in reclaimed:
        coord.task_finished(task.task_id)
    return dict(step=meta["step"], losses=losses,
                weights=_weights(fluid, main),
                reclaimed=sorted(t.payload for t in reclaimed))


def test_hybrid_elastic_resume_matches_the_jax_oracle(tmp_path):
    from paddle_tpu_torch.distributed.coordinator import (
        Coordinator, CoordinatorServer)

    snap, oracle_run = _jax_oracle(lstm_model, lstm_batch, STEPS)
    ckpt_dir = str(tmp_path / "hckpt")
    report = str(tmp_path / "hyb_%d.json")
    coord = Coordinator(timeout_s=600.0)
    coord.set_dataset(SLICES)
    svc = CoordinatorServer(coord, host="127.0.0.1", port=0).start()
    try:
        procs = start(_hybrid_worker, 4, tmp_path, snap, ckpt_dir,
                      svc.address, report)
        try:
            oracle, final = oracle_run()
            _wait_files([report % r for r in range(4)], procs)
        finally:
            kill(procs)
        # the leases of the dead ranks expire now
        with coord._lock:
            for task in coord.pending.values():
                task.deadline = time.time()
        ranks = [json.load(open(report % r)) for r in range(4)]
        for r in ranks[1:]:
            np.testing.assert_allclose(r["losses"], ranks[0]["losses"],
                                       rtol=1e-6)
        assert sorted({tuple(r["lo_hi"]) for r in ranks}) == \
            [tuple(s) for s in SLICES]
        # hy_in [8, 16] split over model; hy_out [4, 4] over dcn x model
        assert all(r["here"] == {"hy_in": [8, 8], "hy_out": [2, 2]}
                   for r in ranks)
        np.testing.assert_allclose(ranks[0]["losses"], oracle[:STEPS_A],
                                   rtol=RTOL)

        (tmp_path / "resume").mkdir()
        (resume,) = spawn(_hybrid_resume_worker, 1, tmp_path / "resume",
                          ckpt_dir, svc.address, init=False)
        assert resume["step"] == STEPS_A - 1
        assert resume["reclaimed"] == SLICES
        np.testing.assert_allclose(resume["losses"], oracle[STEPS_A:],
                                   rtol=RTOL)
        _check_weights(resume["weights"], final)
        assert len(coord.done) == len(SLICES)
    finally:
        svc.stop()
