"""Reader creators from storage (counterpart of
paddle_tpu/v2/reader/creator.py; reference python/paddle/v2/reader/
creator.py: np_array, text_file, recordio).

The record readers of the JAX package stream through its native C++
prefetch queue (`native/`), its RecordShard format (`data/`) and the
master's task queue (`v2/master`); none of those is ported yet (ROADMAP
Queue A), so `recordio`, `pickled_records`, `record_shard` and
`cloud_reader` raise NotImplementedError. They never fall back to a
Python reader."""

from __future__ import annotations

__all__ = ["np_array", "text_file", "recordio", "pickled_records",
           "record_shard", "cloud_reader"]

_NOT_PORTED = (
    "%s reads through the JAX package's %s, which paddle_tpu_torch does "
    "not port yet (ROADMAP Queue A: the native recordio reader and the v2 "
    "data sources)")


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
    """Raw-bytes reader over record files: not ported (the native
    prefetcher)."""
    raise NotImplementedError(
        _NOT_PORTED % ("creator.recordio", "native C++ prefetch queue"))


def pickled_records(paths, buf_size=100):
    """recordio + pickle.loads per record: not ported (see recordio)."""
    raise NotImplementedError(
        _NOT_PORTED % ("creator.pickled_records",
                       "native C++ prefetch queue"))


def record_shard(paths, decode_fn=None):
    """Reader over RecordShard chunked shards: not ported (the input
    pipeline `data/`)."""
    raise NotImplementedError(
        _NOT_PORTED % ("creator.record_shard", "input pipeline (data/)"))


def cloud_reader(paths, etcd_endpoints=None, timeout_sec=5, buf_size=64):
    """Records through the master's task queue: not ported (v2.master and
    the coordinator)."""
    raise NotImplementedError(
        _NOT_PORTED % ("creator.cloud_reader", "v2.master task queue"))
