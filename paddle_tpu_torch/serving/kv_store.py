"""Durable KV tier (counterpart of paddle_tpu/serving/kv_store.py, the
port's own copy: numpy and the standard library only).

  block SERIALIZATION    a closed KV block leaves an engine as a
                         self-describing record: the raw storage bytes
                         of every (layer, band) slice — quantized codes
                         AND their per-(block, head) scale rows — plus
                         the block's token tuple, its chain key
                         (`prefix_cache.fold_key`, the one key
                         definition the trie summary uses), and the
                         block's device fingerprint, which is the
                         transfer checksum. A host-side crc32 of the
                         payload guards the record at rest; the device
                         fingerprint, recomputed on the importing
                         device after upload, guards it end to end.
  HANDOFF                a migrated or resumed request carries its
                         finished prefix's records; the target engine
                         imports them into its pool after fingerprint
                         verification, so the clean path re-prefills no
                         closed block. Re-prefill is the fallback on a
                         mismatch or a hole: counted, never wrong.
  tiered PREFIX STORE    closed blocks spill here write-through at
                         publish; the store holds them in host RAM and
                         (with `dir=`) an append-only `store.jsonl`:
                         torn final line tolerated, compaction via tmp
                         + fsync + os.replace. Eviction is leaf-first
                         LRU under a byte budget. A restarted engine
                         warms its trie FROM the store.
  QUARANTINE             a record whose payload fails its crc (or whose
                         fingerprint fails on the device) is skipped,
                         dropped and quarantined — never served, sticky
                         across restarts.

A mid-file garbage line in `store.jsonl` is skipped and counted
(`corrupt_dropped`): the store is a cache of recomputable state.

The on-disk format is the JAX package's, record for record, so either
package reads a store the other wrote. Fingerprints are computed by each
package's own reduction: a record from the other package is judged by
the fingerprint recomputed here and, if it disagrees, falls back to
re-prefill.

Threading: one store may be shared by several engines, so it carries its
own lock.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import zlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .prefix_cache import fold_key

__all__ = ["KVBlockStore", "make_block_record", "payload_crc"]


def payload_crc(payload: bytes) -> int:
    """The ONE at-rest checksum definition: crc32 over the raw payload
    bytes. Host-side only — the end-to-end check is the device
    fingerprint carried in the record."""
    return zlib.crc32(payload) & 0xFFFFFFFF


def make_block_record(key: int, parent: int, tokens, fp: float,  # band-verb: serialize
                      payload: bytes, meta, kv_quant: str = "none") -> dict:
    """Build one self-describing block record. `meta` lists the
    payload's concatenated slices as (name, dtype, shape) with name
    "<layer>.<band>" — enough for any pool of the same config to
    reassemble the block without the exporter's engine. `fp` is the
    committed device fingerprint (integrity.BlockFingerprints), the
    transfer checksum the importer re-verifies on its own device."""
    return {
        "key": int(key),
        "parent": int(parent),
        "tokens": tuple(int(t) for t in tokens),
        "fp": float(fp),
        "crc": payload_crc(payload),
        "nbytes": len(payload),
        "kv_quant": str(kv_quant),
        "meta": [(str(n), str(d), tuple(int(x) for x in s))
                 for n, d, s in meta],
        "payload": bytes(payload),
    }


def _encode(rec: dict) -> dict:  # band-verb: serialize
    """Record -> JSON-serialisable dict (payload base64)."""
    out = dict(rec)
    out["tokens"] = [int(t) for t in rec["tokens"]]
    out["meta"] = [[n, d, list(s)] for n, d, s in rec["meta"]]
    out["payload"] = base64.b64encode(rec["payload"]).decode("ascii")
    return out


def _decode(obj: dict) -> dict:  # band-verb: import
    """JSON dict -> record (inverse of _encode). Raises on any
    malformed field — the caller treats a raise as a corrupt line."""
    return {
        "key": int(obj["key"]),
        "parent": int(obj["parent"]),
        "tokens": tuple(int(t) for t in obj["tokens"]),
        "fp": float(obj["fp"]),
        "crc": int(obj["crc"]),
        "nbytes": int(obj["nbytes"]),
        "kv_quant": str(obj["kv_quant"]),
        "meta": [(str(n), str(d), tuple(int(x) for x in s))
                 for n, d, s in obj["meta"]],
        "payload": base64.b64decode(obj["payload"]),
    }


class KVBlockStore(object):
    """Fleet-shared tiered store of closed KV block records, keyed by
    chain key (`prefix_cache.fold_key` over whole leading blocks).
    Host-RAM resident, optionally durable under `dir`; leaf-first LRU
    eviction under `byte_budget`; crc-verified on every get with
    sticky quarantine on mismatch."""

    def __init__(self, byte_budget: Optional[int] = None,
                 dir: Optional[str] = None, block_tokens: int = 16,
                 fault_injector=None):
        if int(block_tokens) < 1:
            raise ValueError("block_tokens must be >= 1")
        if byte_budget is not None and int(byte_budget) < 1:
            raise ValueError("byte_budget must be >= 1 (or None)")
        # thread: any (every engine sharing the store) — all state below
        # is guarded by _lock unless noted
        self._lock = threading.Lock()
        self.byte_budget = None if byte_budget is None else int(byte_budget)
        self.block_tokens = int(block_tokens)
        self._records: Dict[int, dict] = {}     # guarded-by: _lock
        # key -> number of PRESENT children (leaf == 0): leaf-first
        # eviction's O(1) test
        self._children: Dict[int, int] = {}     # guarded-by: _lock
        self._stamp: Dict[int, int] = {}        # guarded-by: _lock
        self._clock = 0                         # guarded-by: _lock
        self._bytes = 0                         # guarded-by: _lock
        self._quarantined: Set[int] = set()     # guarded-by: _lock
        self._injector = fault_injector         # guarded-by: _lock
        # O(1) counters (ServingMetrics discipline)
        self.puts = 0                           # guarded-by: _lock
        self.hits = 0                           # guarded-by: _lock
        self.misses = 0                         # guarded-by: _lock
        self.evictions = 0                      # guarded-by: _lock
        self.quarantines = 0                    # guarded-by: _lock
        self.corrupt_dropped = 0                # guarded-by: _lock
        self.compactions = 0                    # guarded-by: _lock
        # routing-summary revision cache: rebuilt only when _rev moves
        self._rev = 0                           # guarded-by: _lock
        self._summary_rev = -1                  # guarded-by: _lock
        self._summary: frozenset = frozenset()  # guarded-by: _lock
        self._file = None                       # guarded-by: _lock
        self._file_records = 0                  # guarded-by: _lock
        self._path = None
        if dir is not None:
            os.makedirs(dir, exist_ok=True)
            self._path = os.path.join(dir, "store.jsonl")
            self._load_locked()
            self._file = open(self._path, "a")
            if self._file_records == 0:
                self._append_locked({"kind": "meta",
                                     "block_tokens": self.block_tokens})

    # -- durability -----------------------------------------------------
    def _append_locked(self, obj: dict):
        if self._file is None:
            return
        self._file.write(json.dumps(obj) + "\n")
        self._file.flush()
        self._file_records += 1

    def _load_locked(self):
        """Replay `store.jsonl`: torn FINAL line tolerated (the crash
        the tier exists to survive); mid-file garbage or an ill-formed
        record is SKIPPED and counted — cache, not truth."""
        if not os.path.exists(self._path):
            return
        lines = open(self._path).read().splitlines()
        # a torn tail is only the LAST non-empty line; anything broken
        # earlier is mid-file damage — also survivable, also counted
        for line in lines:
            line = line.strip()
            if not line:
                continue
            self._file_records += 1
            try:
                obj = json.loads(line)
                kind = obj["kind"]
                if kind == "meta":
                    if int(obj["block_tokens"]) != self.block_tokens:
                        raise ValueError(
                            "store at %r was written with block_tokens"
                            "=%r, this store wants %r — one store, one "
                            "block geometry" % (self._path,
                                                obj["block_tokens"],
                                                self.block_tokens))
                elif kind == "put":
                    rec = _decode(obj)
                    self._admit_locked(rec, persist=False)
                elif kind == "evict":
                    self._drop_locked(int(obj["key"]))
                elif kind == "quarantine":
                    key = int(obj["key"])
                    self._drop_locked(key)
                    self._quarantined.add(key)
                else:
                    self.corrupt_dropped += 1
            except ValueError as exc:
                if "block geometry" in str(exc):
                    raise
                self.corrupt_dropped += 1
            except (KeyError, TypeError):
                self.corrupt_dropped += 1
        self._rev += 1

    def _maybe_compact_locked(self):
        """Rewrite the file to live records only (tmp + fsync +
        os.replace — the journal's atomic-commit discipline) once dead
        lines dominate."""
        if self._file is None:
            return
        live = len(self._records) + len(self._quarantined) + 1
        if self._file_records < max(16, 2 * live):
            return
        tmp = self._path + ".tmp"
        with open(tmp, "w") as f:
            f.write(json.dumps({"kind": "meta",
                                "block_tokens": self.block_tokens})
                    + "\n")
            n = 1
            for rec in self._iter_chains_locked():
                f.write(json.dumps({"kind": "put", **_encode(rec)})
                        + "\n")
                n += 1
            for key in sorted(self._quarantined):
                f.write(json.dumps({"kind": "quarantine",
                                    "key": int(key)}) + "\n")
                n += 1
            f.flush()
            os.fsync(f.fileno())
        self._file.close()
        os.replace(tmp, self._path)
        self._file = open(self._path, "a")
        self._file_records = n
        self.compactions += 1

    # -- internals ------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _admit_locked(self, rec: dict, persist: bool) -> bool:
        key = rec["key"]
        if key in self._quarantined:
            return False
        if key in self._records:
            self._stamp[key] = self._tick()
            return True
        self._records[key] = rec
        self._children.setdefault(key, 0)
        if rec["parent"]:
            self._children[rec["parent"]] = (
                self._children.get(rec["parent"], 0) + 1)
        self._bytes += rec["nbytes"]
        self._stamp[key] = self._tick()
        self.puts += 1
        self._rev += 1
        if persist:
            self._append_locked({"kind": "put", **_encode(rec)})
        self._evict_to_budget_locked()
        return key in self._records

    def _drop_locked(self, key: int):  # band-verb: retire
        rec = self._records.pop(key, None)
        if rec is None:
            return
        self._bytes -= rec["nbytes"]
        self._stamp.pop(key, None)
        self._children.pop(key, None)
        if rec["parent"] and rec["parent"] in self._children:
            self._children[rec["parent"]] -= 1
        self._rev += 1

    def _evict_to_budget_locked(self):
        if self.byte_budget is None:
            return
        while self._bytes > self.byte_budget and self._records:
            victim = None
            for key in self._records:
                if self._children.get(key, 0) > 0:
                    continue  # not a leaf: evicting would orphan a chain
                if victim is None or self._stamp[key] < self._stamp[victim]:
                    victim = key
            if victim is None:
                return  # cycle-free by construction; defensive only
            self._drop_locked(victim)
            self.evictions += 1
            self._append_locked({"kind": "evict", "key": int(victim)})
        self._maybe_compact_locked()

    def _quarantine_locked(self, key: int):
        if key in self._quarantined:
            return
        self._drop_locked(key)
        self._quarantined.add(key)
        self.quarantines += 1
        self._rev += 1
        self._append_locked({"kind": "quarantine", "key": int(key)})
        self._maybe_compact_locked()

    def _get_locked(self, key: int) -> Optional[dict]:
        if key in self._quarantined:
            self.misses += 1
            return None
        rec = self._records.get(key)
        if rec is None:
            self.misses += 1
            return None
        if (len(rec["payload"]) != rec["nbytes"]
                or payload_crc(rec["payload"]) != rec["crc"]):
            # at-rest corruption: skip, quarantine, never serve
            self._quarantine_locked(key)
            self.misses += 1
            return None
        self._stamp[key] = self._tick()
        self.hits += 1
        return rec

    def _iter_chains_locked(self) -> List[dict]:
        """Live records, every parent before any of its children (the
        order a warm start can replay: ancestors publish first)."""
        out: List[dict] = []
        present = self._records
        # roots: parent absent from the store (0, evicted, or foreign)
        frontier = sorted(k for k, r in present.items()
                          if r["parent"] not in present)
        kids: Dict[int, List[int]] = {}
        for k, r in present.items():
            if r["parent"] in present:
                kids.setdefault(r["parent"], []).append(k)
        while frontier:
            key = frontier.pop(0)
            out.append(present[key])
            frontier.extend(sorted(kids.get(key, ())))
        return out

    # -- public API -----------------------------------------------------
    def put(self, record: dict) -> bool:
        """Admit one closed-block record (idempotent per key; a
        quarantined key is refused — its lineage is suspect). Applies
        any armed `store_corrupt@N`/`store_trunc@N` fault to the
        record AT REST (RAM and file both) so the read path's crc
        check is what catches it. May evict leaf-first to stay under
        the byte budget; returns False when the record was refused or
        immediately evicted."""
        with self._lock:
            rec = dict(record)
            if self._injector is not None:
                fault = self._injector.store_tick()
                if fault == "corrupt" and rec["payload"]:
                    pay = bytearray(rec["payload"])
                    pay[0] ^= 0x5A
                    rec["payload"] = bytes(pay)
                elif fault == "trunc":
                    rec["payload"] = rec["payload"][:-4] \
                        if len(rec["payload"]) > 4 else b""
            if self.byte_budget is not None \
                    and rec["nbytes"] > self.byte_budget:
                return False
            return self._admit_locked(rec, persist=True)

    def get(self, key: int) -> Optional[dict]:
        """Fetch one record, crc-verified: a mismatch (bit-rot, an
        injected store fault) quarantines the key and returns None —
        the caller falls back to re-prefill, counted, never wrong."""
        with self._lock:
            return self._get_locked(int(key))

    def chain_fetch(self, tokens, block_tokens: Optional[int] = None  # band-verb: alias
                    ) -> List[dict]:
        """Records covering the leading whole blocks of `tokens`, in
        chain order, stopping at the first miss/quarantined/corrupt
        entry (an interior hole makes the tail unusable — blocks
        import in order or not at all). Each record's token tuple is
        re-checked against the probe (crc-collision guard: chain keys
        only STEER, bytes decide)."""
        Bt = int(block_tokens or self.block_tokens)
        tokens = [int(t) for t in np.asarray(tokens).reshape(-1)]
        out: List[dict] = []
        acc = 0
        with self._lock:
            for d in range(len(tokens) // Bt):
                block = tuple(tokens[d * Bt:(d + 1) * Bt])
                acc = fold_key(acc, block)
                rec = self._get_locked(acc)
                if rec is None or rec["tokens"] != block:
                    break
                out.append(rec)
        return out

    def quarantine(self, key: int):
        """Mark a key as never-servable (sticky, persisted). Called by
        the store itself on crc mismatch and by importers whose
        ON-DEVICE fingerprint check failed — the record read clean
        from disk but its content lies."""
        with self._lock:
            self._quarantine_locked(int(key))

    def evict(self, key: int) -> bool:
        """Drop one record (drills / explicit cold-path management).
        Unlike budget eviction this accepts interior keys — the chain's
        tail simply becomes unreachable to `chain_fetch`."""
        with self._lock:
            if int(key) not in self._records:
                return False
            self._drop_locked(int(key))
            self.evictions += 1
            self._append_locked({"kind": "evict", "key": int(key)})
            # an unbudgeted-but-durable store still accumulates dead
            # lines through explicit evicts — rotate here too
            self._maybe_compact_locked()
            return True

    def summary(self) -> frozenset:
        """Chain keys of every servable record — the router's
        store-awareness: what ANY replica can cheaply restore.
        Revision-cached; same key definition as
        `PrefixCache.summary()`."""
        with self._lock:
            if self._summary_rev != self._rev:
                self._summary = frozenset(self._records)
                self._summary_rev = self._rev
            return self._summary

    def iter_chains(self) -> List[dict]:
        """Snapshot of live records, parents before children — the
        warm-start replay order."""
        with self._lock:
            return list(self._iter_chains_locked())

    def close(self):
        with self._lock:
            if self._file is not None:
                self._file.close()
                self._file = None

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def stats(self) -> dict:
        with self._lock:
            return {
                "records": len(self._records),
                "bytes": self._bytes,
                "byte_budget": self.byte_budget,
                "block_tokens": self.block_tokens,
                "puts": self.puts,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "quarantined": len(self._quarantined),
                "quarantines": self.quarantines,
                "corrupt_dropped": self.corrupt_dropped,
                "compactions": self.compactions,
                "durable": self._path is not None,
            }
