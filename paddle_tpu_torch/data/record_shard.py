"""RecordShard: the chunked on-disk shard format of the input pipeline
(counterpart of paddle_tpu/data/record_shard.py, in its on-disk format:
a shard written by either package reads in the other).

The reference's Go master dispatches RecordIO *chunks* — not files and
not single records — because a chunk is the smallest unit that can be
leased, retried, and CRC-verified independently (go/master/service.go
partitions by chunk index). This module reproduces that capability as a
pure-Python format (no toolchain needed, unlike the native recordio in
`paddle_tpu_torch.native`, which this format maps onto — `from_recordio`
converts, and both sides speak "iterable of raw record bytes"):

    shard  := chunk*
    chunk  := header payload
    header := '<IIII'  magic | num_records | payload_len | crc32(payload)
    payload:= ('<I' record_len ++ record_bytes)*

Properties the loader relies on:
  - the chunk index (offsets + record counts) is recoverable by a
    header-only scan, so a dataset over many shards indexes in O(chunks)
    reads without touching payload bytes;
  - every chunk carries its own CRC32, so a torn write or bit flip is
    detected at the chunk that contains it (load_chunk raises IOError),
    mirroring the checkpoint module's corrupt-shard rejection;
  - writers commit via atomic rename, so a reader never sees a partial
    shard (same discipline as checkpoint.py / the coordinator snapshot).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Iterable, List

__all__ = ["MAGIC", "ShardWriter", "RecordShard", "write_shard",
           "from_recordio"]

MAGIC = 0x52534844  # "RSHD"
_HEADER = struct.Struct("<IIII")
_LEN = struct.Struct("<I")


class ShardWriter(object):
    """Append records, flush them as CRC-checked chunks, commit the shard
    atomically on close(). An exception inside the `with` block aborts
    (the temp file is removed; the target path is never touched)."""

    def __init__(self, path: str, records_per_chunk: int = 256):
        if records_per_chunk < 1:
            raise ValueError("records_per_chunk must be >= 1")
        self.path = path
        self.records_per_chunk = int(records_per_chunk)
        self._tmp = path + ".tmp"
        self._f = open(self._tmp, "wb")
        self._buf: List[bytes] = []
        self.num_records = 0
        self.num_chunks = 0

    def write(self, record: bytes):
        self._buf.append(bytes(record))
        self.num_records += 1
        if len(self._buf) >= self.records_per_chunk:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._buf:
            return
        payload = b"".join(_LEN.pack(len(r)) + r for r in self._buf)
        self._f.write(_HEADER.pack(MAGIC, len(self._buf), len(payload),
                                   zlib.crc32(payload) & 0xFFFFFFFF))
        self._f.write(payload)
        self.num_chunks += 1
        self._buf = []

    def close(self):
        if self._f is None:
            return
        self._flush_chunk()
        self._f.close()
        self._f = None
        os.replace(self._tmp, self.path)  # atomic commit

    def abort(self):
        if self._f is None:
            return
        self._f.close()
        self._f = None
        try:
            os.remove(self._tmp)
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *a):
        if exc_type is not None:
            self.abort()
        else:
            self.close()


class RecordShard(object):
    """Reader over one shard: indexes chunk headers on open, serves
    whole CRC-verified chunks by index."""

    def __init__(self, path: str):
        self.path = path
        # [(payload_file_offset, num_records, payload_len, crc32)]
        self._chunks: List[tuple] = []
        size = os.path.getsize(path)
        with open(path, "rb") as f:
            pos = 0
            while pos < size:
                head = f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    raise IOError(
                        "%s: truncated chunk header at %d (shard commits "
                        "are atomic — this file is corrupt)" % (path, pos))
                magic, n_rec, p_len, crc = _HEADER.unpack(head)
                if magic != MAGIC:
                    raise IOError(
                        "%s: bad chunk magic 0x%08x at offset %d"
                        % (path, magic, pos))
                payload_at = pos + _HEADER.size
                if payload_at + p_len > size:
                    raise IOError(
                        "%s: chunk at %d claims %d payload bytes past EOF"
                        % (path, pos, p_len))
                self._chunks.append((payload_at, n_rec, p_len, crc))
                pos = payload_at + p_len
                f.seek(pos)

    @property
    def num_chunks(self) -> int:
        return len(self._chunks)

    @property
    def record_counts(self) -> List[int]:
        return [n for _, n, _, _ in self._chunks]

    @property
    def num_records(self) -> int:
        return sum(n for _, n, _, _ in self._chunks)

    def read_chunk(self, k: int) -> List[bytes]:
        off, n_rec, p_len, crc = self._chunks[k]
        with open(self.path, "rb") as f:
            f.seek(off)
            payload = f.read(p_len)
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            raise IOError(
                "%s: chunk %d failed its CRC check (corrupt payload)"
                % (self.path, k))
        records, pos = [], 0
        for _ in range(n_rec):
            (ln,) = _LEN.unpack_from(payload, pos)
            pos += _LEN.size
            records.append(payload[pos:pos + ln])
            pos += ln
        return records

    def iter_records(self) -> Iterable[bytes]:
        for k in range(self.num_chunks):
            for rec in self.read_chunk(k):
                yield rec


def write_shard(path: str, records: Iterable[bytes],
                records_per_chunk: int = 256) -> RecordShard:
    """Write `records` to one shard and return a reader over it."""
    with ShardWriter(path, records_per_chunk=records_per_chunk) as w:
        for rec in records:
            w.write(rec)
    return RecordShard(path)


def from_recordio(src_path: str, dst_path: str,
                  records_per_chunk: int = 256) -> RecordShard:
    """Convert a native record file (`paddle_tpu_torch.native`
    RecordWriter format, which the JAX package's writer shares) into a
    RecordShard — the bridge from the flat native record stream to the
    chunk-leasable shard format."""
    from .. import native

    return write_shard(dst_path, native.read_records(src_path),
                       records_per_chunk=records_per_chunk)
