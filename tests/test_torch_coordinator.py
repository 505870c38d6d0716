"""The port's coordinator (paddle_tpu_torch.distributed.coordinator, the Go
master's counterpart) against the JAX package's: one wire protocol (JSON
lines over TCP), one snapshot file, one lease-generation scheme. Each
lease scenario runs with a port RemoteCoordinator against a JAX
CoordinatorServer and the other way round (and port against port), and
its log of answers must equal the JAX-against-JAX log exactly; a
snapshot written by either package recovers in the other."""

import json
import socket
import time

import pytest

import paddle_tpu.distributed.coordinator as jcoord
import paddle_tpu_torch.distributed.coordinator as tcoord

PKG = {"jax": jcoord, "torch": tcoord}
COMBOS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


def _serve(server_side, **kw):
    c = PKG[server_side].Coordinator(**kw)
    return c, PKG[server_side].CoordinatorServer(c).start()


def _client(client_side, server):
    return PKG[client_side].RemoteCoordinator(server.address, timeout_s=10,
                                              retry_deadline_s=10)


def _task(t):
    return None if t is None else t.to_json()


def _lease_cycle(c, coord):
    c.set_dataset(["s0", "s1", "s2"])
    log = [_task(c.get_task()), _task(c.get_task())]
    for t in log:
        c.task_finished(t["task_id"], lease=t["lease"])
    t2 = c.get_task()
    log += [_task(t2), _task(c.get_task())]
    c.task_finished(t2.task_id, lease=t2.lease)
    log.append(_task(c.get_task()))            # pass ended: no rollover
    log.append(_task(c.get_task(epoch_limit=1)))  # explicit next pass
    log.append(c.ping())
    return log


def _timeout_requeue(c, coord):
    c.set_dataset(["only"])
    t = c.get_task()
    time.sleep(0.25)  # the lease expires: its holder is presumed dead
    t2 = c.get_task()
    return [_task(t), _task(t2)]


def _failure_max(c, coord):
    c.set_dataset(["bad", "good"])
    log = []
    for _ in range(2):
        ts = [c.get_task(), c.get_task()]
        for t in ts:
            if t is not None and t.payload == "good":
                c.task_finished(t.task_id, lease=t.lease)
        bad = [t for t in ts if t is not None and t.payload == "bad"][0]
        c.task_failed(bad.task_id, offset=2, lease=bad.lease)
        log.append(_task(bad))
    while True:  # 'bad' is discarded for this pass
        t = c.get_task()
        if t is None:
            break
        log.append(_task(t))
        c.task_finished(t.task_id, lease=t.lease)
    log.append([t.payload for t in coord.discarded])
    return log


def _fencing(c, coord):
    """Progress, expiry, re-lease: the zombie holder's calls under the old
    generation are refused, the new holder's work."""
    c.set_dataset(["s0"])
    a = c.get_task()
    log = [_task(a), c.task_progress(a.task_id, 3, lease=a.lease),
           c.task_progress(a.task_id, 1, lease=a.lease)]
    time.sleep(0.25)
    b = c.get_task()
    log += [_task(b), c.task_progress(a.task_id, 9, lease=a.lease)]
    c.task_finished(a.task_id, lease=a.lease)
    c.task_failed(a.task_id, offset=9, lease=a.lease)
    log.append(sorted(coord.pending))
    log.append(c.task_progress(b.task_id, 5, lease=b.lease))
    c.task_finished(b.task_id, lease=b.lease)
    log.append(c.task_progress(b.task_id, 6, lease=b.lease))
    log.append([t.to_json() for t in coord.done])
    return log


def _membership(c, coord):
    log = [c.register_worker("w0", meta={"restart_reason": "none"}),
           c.register_worker("w0")]
    c.heartbeat("w0", step=4)
    m = c.membership()["w0"]
    log.append({k: m[k] for k in ("incarnation", "step", "alive", "meta")})
    return log


SCENARIOS = {
    "lease_cycle": (_lease_cycle, {}),
    "timeout_requeue": (_timeout_requeue, {"timeout_s": 0.1}),
    "failure_max": (_failure_max, {"failure_max": 2}),
    "fencing": (_fencing, {"timeout_s": 0.1, "failure_max": 10}),
    "membership": (_membership, {}),
}


def _run(server_side, client_side, name):
    fn, kw = SCENARIOS[name]
    coord, server = _serve(server_side, **dict({"timeout_s": 60}, **kw))
    client = _client(client_side, server)
    try:
        return fn(client, coord)
    finally:
        client.close()
        server.stop()


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("server_side,client_side", COMBOS)
def test_lease_protocol_across_packages(name, server_side, client_side):
    want = _run("jax", "jax", name)
    assert _run(server_side, client_side, name) == want


def test_wire_answers_are_byte_equal():
    """The same request lines sent to a JAX and a port server get the
    same answer lines, byte for byte (a deadline never crosses the
    wire)."""
    requests = [
        {"method": "ping"},
        {"method": "set_dataset", "params": {"shards": [{"chunk": 0},
                                                        {"chunk": 1}]}},
        {"method": "get_task", "params": {"epoch_limit": 0}},
        {"method": "task_progress", "params": {"task_id": 0, "offset": 4,
                                               "lease": 1}},
        {"method": "task_progress", "params": {"task_id": 0, "offset": 5,
                                               "lease": 7}},
        {"method": "task_finished", "params": {"task_id": 0, "lease": 1}},
        {"method": "get_task", "params": {"epoch_limit": 0}},
        {"method": "task_failed", "params": {"task_id": 1, "offset": 2,
                                             "lease": 1}},
        {"method": "get_task", "params": {}},
        {"method": "no_such_method"},
    ]
    answers = {}
    for side in PKG:
        coord, server = _serve(side, timeout_s=60)
        with socket.create_connection((server.host, server.port),
                                      timeout=10) as s:
            f = s.makefile("rwb")
            out = []
            for r in requests:
                f.write((json.dumps(r) + "\n").encode())
                f.flush()
                out.append(f.readline())
            f.write(b"not json\n")
            f.flush()
            out.append(json.loads(f.readline())["ok"])
        server.stop()
        answers[side] = out
    assert answers["torch"] == answers["jax"]


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_snapshot_recovers_across_packages(tmp_path, writer, reader):
    """A snapshot written by one package's coordinator (a finished task,
    an offset on a lease whose holder died, a failure) recovers in the
    other's: the dead lease back in todo with its offset, done kept."""
    snap = str(tmp_path / "master.json")
    c = PKG[writer].Coordinator(timeout_s=60, snapshot_path=snap)
    c.set_dataset(["a", "b", "c", "d"])
    t = c.get_task()
    c.task_finished(t.task_id, lease=t.lease)
    t = c.get_task()
    c.task_failed(t.task_id, offset=1, lease=t.lease)
    t = c.get_task()
    c.task_progress(t.task_id, 5, lease=t.lease)  # then its worker dies
    written = open(snap).read()
    del c
    c2 = PKG[reader].Coordinator(timeout_s=60, snapshot_path=snap)
    cref = jcoord.Coordinator(timeout_s=60, snapshot_path=snap)
    assert [x.to_json() for x in c2.todo] == [x.to_json() for x in cref.todo]
    assert [x.to_json() for x in c2.done] == [x.to_json() for x in cref.done]
    got = []
    while True:
        t = c2.get_task()
        if t is None:
            break
        got.append((t.payload, t.offset, t.failures))
        c2.task_finished(t.task_id, lease=t.lease)
    assert sorted(got) == [("b", 1, 1), ("c", 5, 0), ("d", 0, 0)]
    # the reader's own snapshot reads back in the writer's package too
    again = PKG[writer].Coordinator(timeout_s=60, snapshot_path=snap)
    assert len(again.done) == 4 and not again.todo
    assert written != open(snap).read()


def test_remote_coordinator_rides_out_a_restart(tmp_path):
    """A port client keeps its calls through a JAX server that goes away
    and comes back on the same port, recovered from its snapshot."""
    snap = str(tmp_path / "m.json")
    c = jcoord.Coordinator(timeout_s=60, snapshot_path=snap)
    server = jcoord.CoordinatorServer(c).start()
    port = server.port
    c.set_dataset(["x", "y"])
    client = tcoord.RemoteCoordinator(server.address, timeout_s=5,
                                      retry_deadline_s=10,
                                      backoff_base_s=0.02)
    t = client.get_task()
    server.stop()
    # the server process's death takes its connections with it
    client._sock.shutdown(socket.SHUT_RDWR)
    c2 = jcoord.Coordinator(timeout_s=60, snapshot_path=snap)
    server2 = jcoord.CoordinatorServer(c2, port=port).start()
    try:
        got = []
        while True:
            t2 = client.get_task()
            if t2 is None:
                break
            got.append(t2.payload)
            client.task_finished(t2.task_id, lease=t2.lease)
        assert sorted(got) == ["x", "y"]  # the dead lease came back
        assert t.payload in got
    finally:
        client.close()
        server2.stop()


def test_master_client_resumes_at_the_offset():
    """The port's MasterClient: a reader that fails mid-chunk reports its
    offset, and the re-lease skips the records already yielded."""
    c = tcoord.Coordinator(timeout_s=60, failure_max=10)
    c.set_dataset([0, 1])
    crashes = []

    def record_fn(payload):
        for i in range(4):
            if payload == 1 and i == 2 and not crashes:
                crashes.append(i)
                raise IOError("transient mid-chunk error")
            yield payload * 10 + i

    got = list(tcoord.MasterClient(c, record_fn))
    assert sorted(got) == [0, 1, 2, 3, 10, 11, 12, 13]
    assert crashes == [2]


def test_v2_master_client_over_a_jax_server(tmp_path):
    """paddle_tpu_torch.v2.master.client with a "host:port" endpoint
    leases record files from a JAX CoordinatorServer and yields their
    records; each pass ends with None and the next call starts the next
    pass."""
    import pickle

    import paddle_tpu_torch.native as native
    from paddle_tpu_torch.v2 import master

    paths = []
    for s in range(3):
        p = str(tmp_path / ("part%d.rio" % s))
        with native.RecordWriter(p) as w:
            for i in range(4):
                w.write(pickle.dumps((s, i)))
        paths.append(p)
    coord, server = _serve("jax", timeout_s=60)
    try:
        cli = master.client("etcd://" + server.address, timeout_sec=10)
        cli.set_dataset(paths)
        passes = []
        for _ in range(2):
            got = []
            while True:
                r = cli.next_record()
                if r is None:
                    break
                got.append(pickle.loads(r))
            passes.append(sorted(got))
        want = sorted((s, i) for s in range(3) for i in range(4))
        assert passes == [want, want]
        assert coord.epoch == 1
    finally:
        server.stop()
