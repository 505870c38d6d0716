"""ShardedDataset (counterpart of paddle_tpu/data/dataset.py, with the
same seed folds, so both packages visit chunks and records in one order):
a logical dataset over RecordShard files, indexed at chunk granularity — the unit the loader prefetches and the coordinator
leases (the Go master's partition-by-chunk, go/master/service.go:106).

Determinism contract (what makes exact mid-epoch resume possible): for a
fixed (seed, epoch) the chunk visitation order and the record order
within every chunk are pure functions — `epoch_order(epoch)` and
`record_order(epoch, chunk)` fold the epoch (and chunk id) into the seed
— so any position in an epoch's record stream is fully described by a
(chunk cursor, record offset) pair and can be re-entered exactly after a
crash, on any process.
"""

from __future__ import annotations

import zlib
from typing import Callable, List, Optional

import numpy as np

from .record_shard import RecordShard

__all__ = ["ChunkRef", "ShardedDataset"]


def _fold(seed: int, *vals) -> int:
    """Deterministic 32-bit fold of (seed, *vals) — stable across
    processes and runs (unlike hash(), which is salted)."""
    key = ("%d|" % seed) + "|".join(str(v) for v in vals)
    return zlib.crc32(key.encode()) & 0xFFFFFFFF


class ChunkRef(object):
    """One leasable unit of work: chunk `chunk` of shard `shard`."""

    __slots__ = ("shard", "chunk", "records")

    def __init__(self, shard: str, chunk: int, records: int):
        self.shard = shard
        self.chunk = chunk
        self.records = records

    def __repr__(self):
        return "ChunkRef(%r, %d, records=%d)" % (
            self.shard, self.chunk, self.records)


class ShardedDataset(object):
    """Index of every chunk across `shard_paths`, plus the deterministic
    shuffles and the decode hook.

    decode_fn(record_bytes) -> item   per-record decode (pickle.loads,
                                      np.frombuffer, ...); None = raw
    seed                              folds with the epoch (and chunk id)
                                      for the per-epoch shuffles
    shuffle_chunks / shuffle_records  both default True; turning both
                                      off gives storage order
    quarantine_path                   the sentinel's poisoned-chunk
                                      journal (distributed.sentinel):
                                      journaled chunk ids are skipped by
                                      the chunk sources on every pass.
                                      Quarantined chunks stay IN
                                      `epoch_order` — a loader cursor's
                                      `pos` keeps meaning the same chunk
                                      before and after a quarantine, so
                                      rollback resume stays exact; the
                                      skip happens at delivery time.
    """

    def __init__(self, shard_paths: List[str],
                 decode_fn: Optional[Callable] = None, seed: int = 0,
                 shuffle_chunks: bool = True, shuffle_records: bool = True,
                 quarantine_path: Optional[str] = None):
        if isinstance(shard_paths, str):
            shard_paths = [shard_paths]
        self.shard_paths = list(shard_paths)
        self.decode_fn = decode_fn
        self.seed = int(seed)
        self.shuffle_chunks = shuffle_chunks
        self.shuffle_records = shuffle_records
        self.quarantine_path = quarantine_path
        self._quarantined = frozenset()
        self._readers = {p: RecordShard(p) for p in self.shard_paths}
        self.chunks: List[ChunkRef] = []
        for p in self.shard_paths:
            for k, n in enumerate(self._readers[p].record_counts):
                self.chunks.append(ChunkRef(p, k, n))
        if quarantine_path:
            self.reload_quarantine()

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def num_records(self) -> int:
        return sum(c.records for c in self.chunks)

    # --- poisoned-data quarantine (distributed.sentinel) ---------------
    @property
    def quarantined(self) -> frozenset:
        """Global chunk indices currently quarantined (never delivered)."""
        return self._quarantined

    def is_quarantined(self, chunk_index: int) -> bool:
        return int(chunk_index) in self._quarantined

    def reload_quarantine(self) -> frozenset:
        """Re-read the quarantine journal (the sentinel appends to it at
        trip time; every worker re-reads on its next resume, so the
        skip set is identical fleet-wide and across reruns)."""
        if self.quarantine_path:
            from ..distributed.sentinel import quarantined_chunks

            self._quarantined = quarantined_chunks(self.quarantine_path)
        return self._quarantined

    # --- deterministic per-epoch shuffles -----------------------------
    def epoch_order(self, epoch: int) -> List[int]:
        """Global chunk indices in this epoch's visitation order."""
        idx = np.arange(len(self.chunks))
        if self.shuffle_chunks:
            np.random.RandomState(
                _fold(self.seed, "chunks", epoch)).shuffle(idx)
        return idx.tolist()

    def record_order(self, epoch: int, chunk_index: int) -> List[int]:
        """Record positions within chunk `chunk_index` (global index) in
        this epoch's order."""
        n = self.chunks[chunk_index].records
        if not self.shuffle_records:
            return list(range(n))
        return np.random.RandomState(
            _fold(self.seed, "records", epoch, chunk_index)
        ).permutation(n).tolist()

    # --- chunk loading -------------------------------------------------
    def load_chunk(self, chunk_index: int, epoch: int = 0, skip: int = 0):
        """The records of one chunk in epoch order, minus the first
        `skip` (already delivered before a resume / re-lease), decoded.
        CRC failures surface as IOError from the shard reader."""
        ref = self.chunks[chunk_index]
        raw = self._readers[ref.shard].read_chunk(ref.chunk)
        order = self.record_order(epoch, chunk_index)
        out = [raw[i] for i in order[skip:]]
        if self.decode_fn is not None:
            out = [self.decode_fn(r) for r in out]
        return out

    # --- coordinator integration --------------------------------------
    def payloads(self) -> List[dict]:
        """JSON-serializable chunk descriptions for
        `Coordinator.set_dataset` — `chunk` is the global index into
        `self.chunks`, which every worker reconstructs identically from
        the same shard list."""
        return [
            {"chunk": i, "shard": c.shard, "records": c.records}
            for i, c in enumerate(self.chunks)
        ]
