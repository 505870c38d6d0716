"""The port's input pipeline (paddle_tpu_torch.data) against the JAX
package's (paddle_tpu.data) on the same seeded shards: RecordShards
written by either package read byte-equal in the other, the two
ShardedDatasets visit chunks and records in one order, the two
DataLoaders deliver one batch stream for num_workers 0 and 2 over two
epochs with quarantined chunks, their `state_dict()` JSON is equal at
every batch boundary, and a cursor saved by either resumes in the other
at the same record. Streams, cursors and verdicts match exactly: there
is no tolerance. The loader's own behaviours (exact resume, coordinated
leases, loud lease loss) are held on the port as the JAX package's
tests hold them on its loader."""

import json
import os
import pickle
import time

import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.distributed.sentinel as jsent
import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.distributed.sentinel as tsent
from paddle_tpu_torch.distributed import Coordinator

DATA = {"jax": jdata, "torch": tdata}
DIRECTIONS = [("jax", "torch"), ("torch", "jax")]


def _make_shards(tmp_path, data=tdata, n_shards=3, records_per_shard=37,
                 records_per_chunk=10, name="shard"):
    """Shards of pickled (record_id, payload) rows written by `data`'s
    ShardWriter; ids are globally unique."""
    paths, rid = [], 0
    for s in range(n_shards):
        p = str(tmp_path / ("%s%d.rs" % (name, s)))
        with data.ShardWriter(p, records_per_chunk=records_per_chunk) as w:
            for _ in range(records_per_shard):
                w.write(pickle.dumps((rid, float(rid) * 0.5)))
                rid += 1
        paths.append(p)
    return paths, rid


def _batches(loader):
    """One epoch of the loader's batches as plain lists, with the cursor
    after each, and the cursor after the epoch's end."""
    out = []
    for ids, vals in loader:
        out.append((ids.tolist(), vals.tolist(), loader.state_dict()))
    out.append(loader.state_dict())
    return out


def _ids(loader):
    out = []
    for batch in loader:
        out.extend(np.asarray(batch[0]).tolist())
    return out


# ---------------------------------------------------------------------------
# RecordShard: one format
# ---------------------------------------------------------------------------


def test_both_shard_writers_make_the_same_bytes(tmp_path):
    for side, data in DATA.items():
        os.mkdir(tmp_path / side)
        _make_shards(tmp_path / side, data)
    for k in range(3):
        assert (tmp_path / "jax" / ("shard%d.rs" % k)).read_bytes() == \
            (tmp_path / "torch" / ("shard%d.rs" % k)).read_bytes()
    assert tdata.MAGIC == jdata.MAGIC


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_shards_cross_read(tmp_path, writer, reader):
    recs = [b"x" * n for n in (0, 1, 7, 300, 5)]
    p = str(tmp_path / "a.rs")
    DATA[writer].write_shard(p, recs, records_per_chunk=2)
    shard = DATA[reader].RecordShard(p)
    assert shard.record_counts == [2, 2, 1]
    assert list(shard.iter_records()) == recs
    assert shard.read_chunk(1) == recs[2:4]


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_shard_corruption_is_caught_alike(tmp_path, writer, reader):
    """A flipped payload byte fails the chunk's CRC, and a torn tail
    fails the index scan, in both readers."""
    p = tmp_path / "c.rs"
    DATA[writer].write_shard(str(p), [b"record-%d" % i for i in range(8)],
                             records_per_chunk=4)
    good = p.read_bytes()
    raw = bytearray(good)
    raw[-2] ^= 0xFF
    p.write_bytes(bytes(raw))
    shard = DATA[reader].RecordShard(str(p))
    assert shard.read_chunk(0) == [b"record-%d" % i for i in range(4)]
    with pytest.raises(IOError, match="CRC"):
        shard.read_chunk(1)
    p.write_bytes(good[:-3])
    for data in DATA.values():
        with pytest.raises(IOError, match="past EOF"):
            data.RecordShard(str(p))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_from_recordio_through_the_ports_native(tmp_path, writer):
    """A native record file of either package converts into the same
    shard through either package's from_recordio."""
    import paddle_tpu.native as jn
    import paddle_tpu_torch.native as tn
    from torch_native_build import ensure_jax_native

    ensure_jax_native()
    src = str(tmp_path / "n.rio")
    recs = [b"n%d" % i for i in range(10)]
    with {"jax": jn, "torch": tn}[writer].RecordWriter(src) as w:
        for r in recs:
            w.write(r)
    shards = {}
    for side, data in DATA.items():
        shards[side] = str(tmp_path / (side + ".rs"))
        data.from_recordio(src, shards[side], records_per_chunk=4)
    assert open(shards["jax"], "rb").read() == \
        open(shards["torch"], "rb").read()
    assert list(tdata.RecordShard(shards["jax"]).iter_records()) == recs


# ---------------------------------------------------------------------------
# ShardedDataset: one order
# ---------------------------------------------------------------------------


def test_dataset_orders_match(tmp_path):
    paths, _ = _make_shards(tmp_path)
    for seed in (0, 3, 11):
        j = jdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=seed)
        t = tdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=seed)
        assert t.payloads() == j.payloads()
        for epoch in range(4):
            assert t.epoch_order(epoch) == j.epoch_order(epoch)
            for ci in range(t.num_chunks):
                assert t.record_order(epoch, ci) == j.record_order(epoch, ci)
            assert t.load_chunk(5, epoch, skip=3) == \
                j.load_chunk(5, epoch, skip=3)
    flat = tdata.ShardedDataset(paths, shuffle_chunks=False,
                                shuffle_records=False)
    assert flat.epoch_order(2) == list(range(flat.num_chunks))


# ---------------------------------------------------------------------------
# DataLoader: one batch stream, one cursor
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_stream_and_cursors_match_with_quarantine(tmp_path, workers):
    """Two epochs with two chunks quarantined (journaled by the JAX
    sentinel, read by both datasets): the same batches and the same
    state_dict() after every batch, for 0 and 2 decode threads."""
    paths, n = _make_shards(tmp_path)
    q = str(tmp_path / "quarantine.jsonl")
    jsent.quarantine_chunks(q, [2, 7], reason="test")
    runs = {}
    for side, data in DATA.items():
        ds = data.ShardedDataset(paths, decode_fn=pickle.loads, seed=5,
                                 quarantine_path=q)
        assert ds.quarantined == frozenset([2, 7])
        dl = data.DataLoader(ds, batch_size=16, num_workers=workers)
        runs[side] = [_batches(dl) for _ in range(2)]
        dl.close()
    assert runs["torch"] == runs["jax"]
    e0 = [i for ids, _v, _s in runs["torch"][0][:-1] for i in ids]
    skipped = set()
    ds = tdata.ShardedDataset(paths, seed=5)
    for ci in (2, 7):
        first = sum(c.records for c in ds.chunks[:ci])
        skipped |= set(range(first, first + ds.chunks[ci].records))
    assert sorted(e0) == sorted(set(range(n)) - skipped)
    assert runs["torch"][1][-1]["epoch"] == 2


@pytest.mark.parametrize("saver,resumer", DIRECTIONS)
def test_cursor_resumes_across_packages(tmp_path, saver, resumer):
    """A cursor saved mid-chunk by one package's loader, as JSON, resumes
    the other's at the same record: the rest of the epoch and the next
    epoch equal what the saver delivers itself."""
    paths, _ = _make_shards(tmp_path)
    mk = {side: (lambda data: data.DataLoader(
        data.ShardedDataset(paths, decode_fn=pickle.loads, seed=9),
        batch_size=7, num_workers=2))(data)
        for side, data in DATA.items()}
    a = mk[saver]
    it = iter(a)
    for _ in range(3):
        next(it)
    state = json.loads(json.dumps(a.state_dict()))
    assert state["offset"] not in (0, None)
    rest_a = [_batches(a), _batches(a)]
    b = mk[resumer]
    b.load_state_dict(state)
    rest_b = [_batches(b), _batches(b)]
    assert rest_b == rest_a
    a.close(), b.close()


def test_device_put_cpu_place_gives_tensors_equal_to_numpy(tmp_path):
    """device_put=True with CPUPlace(): every field of every batch is a
    CPU tensor equal to the numpy batch the loader delivers without
    device_put (and to the JAX loader's)."""
    from paddle_tpu_torch import fluid

    paths, _ = _make_shards(tmp_path)

    def decode(r):
        rid, v = pickle.loads(r)
        return (np.full((2, 3), rid, np.uint8), np.int64(rid),
                {"v": np.float32(v)})

    want = []
    for data in (jdata, tdata):
        dl = data.DataLoader(data.ShardedDataset(paths, decode_fn=decode,
                                                 seed=1),
                             batch_size=8, num_workers=2)
        want.append(list(dl))
        dl.close()
    dl = tdata.DataLoader(tdata.ShardedDataset(paths, decode_fn=decode,
                                               seed=1),
                          batch_size=8, num_workers=2, device_put=True,
                          place=fluid.CPUPlace())
    got = list(dl)
    dl.close()
    assert len(got) == len(want[0]) == len(want[1])
    for g, w, wj in zip(got, want[1], want[0]):
        for t, a, aj in ((g[0], w[0], wj[0]), (g[1], w[1], wj[1]),
                         (g[2]["v"], w[2]["v"], wj[2]["v"])):
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(), a)
            np.testing.assert_array_equal(a, aj)
            assert t.numpy().dtype == a.dtype


def test_device_put_defaults_to_the_card(tmp_path):
    """No place means the card: without one the loader raises at
    construction, with no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    paths, _ = _make_shards(tmp_path)
    ds = tdata.ShardedDataset(paths, decode_fn=pickle.loads)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DataLoader(ds, batch_size=8, device_put=True)


def test_loader_state_rides_the_ports_checkpoint(tmp_path):
    """`stateful=` on the port's checkpoint: a loader restored from a
    checkpoint the JAX package wrote resumes exactly."""
    import paddle_tpu.fluid as JF
    from paddle_tpu.distributed import save_checkpoint
    from paddle_tpu_torch import fluid as TF
    from paddle_tpu_torch.distributed import resume_or_init

    paths, _ = _make_shards(tmp_path)
    jl = jdata.DataLoader(jdata.ShardedDataset(paths, decode_fn=pickle.loads,
                                               seed=4),
                          batch_size=16, num_workers=0)
    it = iter(jl)
    next(it), next(it)
    scope = JF.executor.Scope()
    scope.set("w", np.arange(4, dtype=np.float32))
    d = str(tmp_path / "ckpt")
    save_checkpoint(scope, d, step=2, extra={"step": 2},
                    stateful={"loader": jl})
    rest = _batches(jl)
    tl = tdata.DataLoader(tdata.ShardedDataset(paths, decode_fn=pickle.loads,
                                               seed=4),
                          batch_size=16, num_workers=2)
    meta = resume_or_init(TF.Scope(), d, stateful={"loader": tl})
    assert meta["step"] == 2
    assert _batches(tl) == rest
    jl.close(), tl.close()


# ---------------------------------------------------------------------------
# the loader's behaviours, on the port
# ---------------------------------------------------------------------------


def test_loader_every_record_once_and_metrics(tmp_path):
    paths, n = _make_shards(tmp_path)
    dl = tdata.DataLoader(tdata.ShardedDataset(paths, decode_fn=pickle.loads,
                                               seed=5),
                          batch_size=16, num_workers=2)
    for _ in dl:
        time.sleep(0.002)
    rep = dl.metrics.report()
    assert rep["records"] == n and rep["epochs_completed"] == 1
    assert 0.0 <= rep["wait_fraction"] <= 1.0
    assert rep["mean_step_s"] >= 0.001
    assert next(dl, None) is None  # exhausted until iter() again
    assert sorted(_ids(dl)) == list(range(n)) and dl.epoch == 2
    dl.close()


@pytest.mark.parametrize("workers", [0, 2])
def test_loader_decode_error_then_retry_resumes(tmp_path, workers):
    paths, n = _make_shards(tmp_path)
    calls = {"n": 0}

    def flaky(rec):
        calls["n"] += 1
        if calls["n"] == 30:
            raise IOError("transient decode error")
        return pickle.loads(rec)

    dl = tdata.DataLoader(tdata.ShardedDataset(paths, decode_fn=flaky,
                                               seed=3),
                          batch_size=16, num_workers=workers)
    got, it = [], iter(dl)
    while True:
        try:
            got.extend(next(it)[0].tolist())
        except StopIteration:
            break
        except IOError:
            it = iter(dl)
    assert sorted(got) == list(range(n)) and dl.epoch == 1
    dl.close()


def test_mixed_packages_split_one_queue_exactly_once(tmp_path):
    """A JAX loader and a port loader lease from one coordinator: every
    record is delivered once across the two."""
    paths, n = _make_shards(tmp_path)
    coord = Coordinator(timeout_s=30)
    loaders = []
    for data in (jdata, tdata):
        ds = data.ShardedDataset(paths, decode_fn=pickle.loads, seed=1)
        loaders.append(data.DataLoader(
            ds, batch_size=16, num_workers=2,
            source=data.CoordinatedChunkSource(coord)))
    tdata.CoordinatedChunkSource(coord).publish(loaders[1].dataset)
    got, done = [], [False, False]
    its = [iter(dl) for dl in loaders]
    while not all(done):
        for k, it in enumerate(its):
            if not done[k]:
                try:
                    got.extend(next(it)[0].tolist())
                except StopIteration:
                    done[k] = True
    assert sorted(got) == list(range(n))
    assert len(coord.done) == loaders[1].dataset.num_chunks
    assert not coord.pending
    for dl in loaders:
        dl.close()


def test_coordinated_crash_resume_exactly_once(tmp_path):
    """The in-process kill drill on the port: the checkpointed cursor's
    resume reclaims its lease at the committed offset; the delivered
    multiset is exact."""
    paths, n = _make_shards(tmp_path, n_shards=2, records_per_shard=40,
                            records_per_chunk=8)
    ds = tdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=1)
    coord = Coordinator(timeout_s=0.5, failure_max=10)
    coord.set_dataset(ds.payloads())
    a = tdata.DataLoader(ds, batch_size=6,
                         source=tdata.CoordinatedChunkSource(coord),
                         num_workers=0, auto_commit=False)
    it = iter(a)
    hist = []
    for _ in range(3):
        hist.extend(next(it)[0].tolist())
        ckpt = {"state": a.state_dict(), "hist": list(hist)}
        a.commit()
    next(it)  # delivered, never checkpointed: lost in the crash
    a.close()
    b = tdata.DataLoader(
        ds, batch_size=6,
        source=tdata.CoordinatedChunkSource(coord, idle_grace_s=3.0,
                                            poll_s=0.05),
        num_workers=0, auto_commit=False)
    b.load_state_dict(ckpt["state"])
    b.commit()
    hist2 = list(ckpt["hist"])
    for batch in b:
        hist2.extend(batch[0].tolist())
        b.commit()
    assert sorted(hist2) == list(range(n))
    assert len(coord.done) == ds.num_chunks and not coord.pending
    b.close()


def test_coordinated_lease_lost_is_loud(tmp_path):
    paths, _ = _make_shards(tmp_path, n_shards=2, records_per_shard=40,
                            records_per_chunk=8)
    ds = tdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=1)
    coord = Coordinator(timeout_s=0.2, failure_max=10)
    coord.set_dataset(ds.payloads())
    w = tdata.DataLoader(ds, batch_size=6,
                         source=tdata.CoordinatedChunkSource(coord),
                         num_workers=0, auto_commit=False)
    it = iter(w)
    next(it)
    w.commit()
    next(it)
    time.sleep(0.3)
    assert coord.get_task() is not None
    assert w.commit() is False
    with pytest.raises(tdata.LeaseLost):
        next(it)
    w.close()


def test_coordinated_source_acks_quarantined_chunks(tmp_path):
    """A quarantined chunk leased to a port loader is acked, never
    delivered, so the pass still drains."""
    paths, n = _make_shards(tmp_path)
    q = str(tmp_path / "q.jsonl")
    tsent.quarantine_chunks(q, [0, 4])
    ds = tdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=2,
                              quarantine_path=q)
    coord = Coordinator(timeout_s=30)
    coord.set_dataset(ds.payloads())
    dl = tdata.DataLoader(ds, batch_size=8, num_workers=2,
                          source=tdata.CoordinatedChunkSource(coord))
    got = _ids(dl)
    dl.close()
    dropped = {i for ci in (0, 4) for i in
               range(sum(c.records for c in ds.chunks[:ci]),
                     sum(c.records for c in ds.chunks[:ci + 1]))}
    assert sorted(got) == sorted(set(range(n)) - dropped)
    assert len(coord.done) == ds.num_chunks and not coord.pending


def test_coordinated_tail_delivers_without_waiting_out_the_grace(tmp_path):
    """At a pass's tail the queue is empty while the loader still holds
    decoded chunks: the port delivers them at once instead of holding
    them for the whole idle grace (the JAX package's loader waits it
    out; ROADMAP Queue C). Same records, same order as with no grace."""
    paths, n = _make_shards(tmp_path, n_shards=1, records_per_shard=48,
                            records_per_chunk=8)
    streams = []
    for grace in (0.0, 4.0):
        ds = tdata.ShardedDataset(paths, decode_fn=pickle.loads, seed=2)
        coord = Coordinator(timeout_s=60)
        coord.set_dataset(ds.payloads())
        dl = tdata.DataLoader(
            ds, batch_size=4, num_workers=2,
            source=tdata.CoordinatedChunkSource(coord, idle_grace_s=grace,
                                                poll_s=0.05))
        streams.append(_ids(dl))
        rep = dl.metrics.report()
        dl.close()
        assert rep["batches"] == 12
        assert rep["max_wait_s"] < 2.0, rep
    assert streams[0] == streams[1] and sorted(streams[0]) == list(range(n))
