"""The port's input-pipeline fault drill (the twin of test_data_drill.py's
acceptance drill, on the CPU): two worker processes of the port drain
one coordinator queue through its DataLoader under its Supervisor; one
is SIGKILLed mid-epoch after a batch it delivered but never
checkpointed, and the Supervisor restarts it from its checkpointed
cursor. The delivered record multiset must equal the dataset exactly,
and the restart's reason must read `crash`. Deadlines are sized several
times above what the drill needs; the assertions are on outcomes, never
on the order in time of what the two workers did."""

import json
import os
import pickle
import signal
import sys

import paddle_tpu_torch.data as tdata
from paddle_tpu_torch.distributed import (Coordinator, CoordinatorServer,
                                          Supervisor)

WORKER_PY = os.path.join(os.path.dirname(__file__), "torch_data_worker.py")
N_SHARDS, RECORDS_PER_SHARD, RECORDS_PER_CHUNK = 2, 48, 8
N_RECORDS = N_SHARDS * RECORDS_PER_SHARD


def _build_shards(tmp_path):
    sdir = tmp_path / "shards"
    sdir.mkdir()
    rid = 0
    for s in range(N_SHARDS):
        with tdata.ShardWriter(str(sdir / ("s%02d.rs" % s)),
                               records_per_chunk=RECORDS_PER_CHUNK) as w:
            for _ in range(RECORDS_PER_SHARD):
                w.write(pickle.dumps((rid, float(rid))))
                rid += 1
    return str(sdir)


def test_supervised_kill_drill_multiset_exact(tmp_path):
    sdir = _build_shards(tmp_path)
    ds = tdata.ShardedDataset(
        [os.path.join(sdir, p) for p in sorted(os.listdir(sdir))], seed=11)
    # a dead incarnation's decode-lookahead leases requeue only after the
    # lease timeout, so the loaders' idle grace exceeds it
    coord = Coordinator(timeout_s=3.0, failure_max=10,
                        heartbeat_timeout_s=60)
    coord.set_dataset(ds.payloads())
    server = CoordinatorServer(coord).start()
    victim = "w0"

    def paths_for(wid):
        return (str(tmp_path / ("out_%s.json" % wid)),
                str(tmp_path / ("ckpt_%s" % wid)))

    def argv_for(wid):
        out, ck = paths_for(wid)
        return [sys.executable, WORKER_PY, out, ck, server.address, sdir]

    def env_for(wid):
        env = dict(os.environ, DATA_STEP_SLEEP="0.02",
                   DATA_IDLE_GRACE_S="5.0", DATA_PEERS="2")
        env.pop("PADDLE_FAULT", None)
        if wid == victim:
            env["PADDLE_FAULT"] = "kill@3"
        return env

    sup = Supervisor(argv_for, ["w0", "w1"], env_for=env_for,
                     coordinator=coord, min_uptime_s=0.5,
                     ckpt_dir_for=lambda wid: paths_for(wid)[1])
    try:
        report = sup.run(deadline_s=120)
    finally:
        server.stop()

    assert report["ok"], report
    w = report["workers"]
    assert w[victim]["restarts"] == 1
    assert w[victim]["exit_codes"][0] == -signal.SIGKILL
    assert w[victim]["restart_reasons"] == ["crash"]
    assert w["w1"]["restarts"] == 0
    recs = [json.load(open(paths_for(wid)[0])) for wid in ("w0", "w1")]
    # kill@3 fired after batch 3's delivery: 2 batches were checkpointed
    assert recs[0]["restart_count"] == 1 and recs[0]["resumed_from"] == 2
    union = recs[0]["history"] + recs[1]["history"]
    assert sorted(union) == list(range(N_RECORDS)), (
        "lost/duplicated records: %d delivered vs %d" % (len(union),
                                                          N_RECORDS))
    assert len(coord.done) == ds.num_chunks
    assert not coord.pending and not coord.todo
    assert recs[0]["modules"] == recs[1]["modules"] == []
