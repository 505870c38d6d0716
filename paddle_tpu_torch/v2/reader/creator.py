"""Reader creators from storage (counterpart of
paddle_tpu/v2/reader/creator.py; reference python/paddle/v2/reader/
creator.py: np_array, text_file, recordio).

`recordio` streams through the native C++ prefetch queue
(`paddle_tpu_torch.native`), `record_shard` reads RecordShard files
(`paddle_tpu_torch.data`) and `cloud_reader` takes its records through
the master's task queue (`v2.master`). Record files and shards are the
JAX package's formats, so these readers yield what its readers yield
on the same files. Without a C++ toolchain `recordio` raises: there is
no Python reader in its place."""

from __future__ import annotations

import pickle

__all__ = ["np_array", "text_file", "recordio", "pickled_records",
           "record_shard", "cloud_reader"]


def np_array(x):
    def reader():
        for e in x:
            yield e

    return reader


def text_file(path):
    def reader():
        with open(path) as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, buf_size=100):
    """Raw-bytes reader over record files via the native async prefetcher."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from ... import native

        yield from native.PrefetchReader(list(paths), capacity=buf_size)

    return reader


def pickled_records(paths, buf_size=100):
    """recordio + pickle.loads per record (the common case: each record is
    one training instance tuple). Unpickle only files this program or a
    trusted writer made: unpickling runs code."""
    base = recordio(paths, buf_size)

    def reader():
        for raw in base():
            yield pickle.loads(raw)

    return reader


def record_shard(paths, decode_fn=None):
    """Raw-bytes (or decoded) reader over RecordShard chunked shards
    (paddle_tpu_torch.data.record_shard) — the v2-reader face of the
    input pipeline's storage format; for prefetching/sharding use
    `paddle_tpu_torch.data.DataLoader` directly."""
    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        from ...data.record_shard import RecordShard

        for p in paths:
            for rec in RecordShard(p).iter_records():
                yield decode_fn(rec) if decode_fn is not None else rec

    return reader


def cloud_reader(paths, etcd_endpoints=None, timeout_sec=5, buf_size=64):
    """Records dispatched through the master/coordinator task queue
    (reference creator.py cloud_reader over the Go master + etcd; the
    Coordinator service provides the same lease/retry semantics).
    `etcd_endpoints` may be a coordinator "host:port" (shared queue
    across workers) or None for an in-process coordinator. Records are
    pickled python objects, as written by v2.dataset.common.convert —
    exactly the reference's cPickle.loads contract. Each call of the
    returned reader consumes one pass (coordinator epoch)."""
    from ..master import client as master_client

    if isinstance(paths, str):
        paths = [paths]
    c = master_client(etcd_endpoints, timeout_sec, buf_size)
    c.set_dataset(list(paths))

    def reader():
        while True:
            r = c.next_record()
            if r is None:
                break
            yield pickle.loads(r)

    return reader
