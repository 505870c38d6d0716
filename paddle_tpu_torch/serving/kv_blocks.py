"""Host-side allocator for the paged KV block pool.

The serving engine's KV cache is a device-resident pool of fixed-size
token blocks ([num_blocks, block_tokens, H, Dh] per layer); this class
owns the HOST bookkeeping: which physical blocks are free, how many
table rows / prefix-trie nodes reference each block, and how many
blocks are *reserved* for admitted requests but not yet materialised.

Reservation vs allocation is the whole point (the reference's
PoolAllocator.h/MemoryHandle discipline recast):

  * admission RESERVES the request's worst case
    (ceil((T0 + max_new) / block_tokens) blocks, minus blocks it
    aliases from the prefix trie), so an admitted request can never
    deadlock mid-decode waiting for a block;
  * blocks are ALLOCATED on demand as the sequence actually grows
    (prefill chunks / decode crossing a block boundary), so
    `blocks_in_use` — the HBM actually resident — tracks tokens
    written, not the worst case;
  * retirement frees the allocated blocks (ref-counted: a block shared
    with the prefix trie or another slot survives) and releases the
    unreached reservation tail, so an early-EOS request returns
    capacity it never touched.

Ref-counts make sharing safe: a prefix-cache hit writes the SAME
physical block id into a second slot's table (zero-copy aliasing) and
increfs it; the trie holds its own ref on published blocks. A block
returns to the free list only when the last reference drops.

Pure host bookkeeping (numpy only), unit-testable without a device. All
state is confined to the engine's scheduler thread (same discipline as
the engine side-bands; lock_lint checks the annotations).
"""

from __future__ import annotations

import numpy as np

__all__ = ["KVBlockAllocator"]


class KVBlockAllocator(object):
    """Free-list + ref-count + reservation accounting over `num_blocks`
    physical KV blocks of `block_tokens` tokens each."""

    def __init__(self, num_blocks: int, block_tokens: int,
                 block_bytes=None):
        if int(num_blocks) < 1:
            raise ValueError("num_blocks must be >= 1")
        if int(block_tokens) < 1:
            raise ValueError("block_tokens must be >= 1")
        self.num_blocks = int(num_blocks)
        self.block_tokens = int(block_tokens)
        # one block's HBM cost (payload over all layers + any quant
        # scale side-bands — the engine computes it from the STORAGE
        # dtype), so stats() can report bytes honestly for
        # int8/fp8 pools; None = unknown (host-only unit tests)
        self.block_bytes = None if block_bytes is None else int(block_bytes)
        # LIFO free list (ascending ids pop first — deterministic
        # layouts for the fixed-seed drills)
        self._free = list(range(self.num_blocks - 1, -1, -1))  # guarded-by: scheduler
        self._refs = np.zeros(self.num_blocks, np.int32)  # guarded-by: scheduler
        self._reserved = 0                    # guarded-by: scheduler
        # O(1) counters (ServingMetrics discipline)
        self.allocated_total = 0              # guarded-by: scheduler
        self.freed_total = 0                  # guarded-by: scheduler

    # -- capacity -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def available(self) -> int:
        """Blocks an admission may still reserve: free minus what other
        admitted requests have reserved but not yet allocated."""
        return len(self._free) - self._reserved

    @property
    def blocks_in_use(self) -> int:
        return self.num_blocks - len(self._free)

    @property
    def reserved(self) -> int:
        return self._reserved

    # -- reservations ---------------------------------------------------
    def reserve(self, n: int) -> bool:
        """Reserve `n` blocks for a request's worst case; False (and no
        state change) when the pool cannot cover it — the caller keeps
        the request queued (backpressure, never a raise)."""
        if n < 0:
            raise ValueError("reserve needs n >= 0")
        if self.available < n:
            return False
        self._reserved += n
        return True

    def release_reservation(self, n: int):
        """Return `n` reserved-but-never-allocated blocks (the
        unreached tail of a retiring request)."""
        if n < 0 or n > self._reserved:
            raise ValueError(
                "release_reservation(%d) with %d outstanding"
                % (n, self._reserved))
        self._reserved -= n

    # -- allocation / ref-counts ---------------------------------------
    def alloc_reserved(self) -> int:
        """Materialise one previously reserved block (refcount 1)."""
        if self._reserved < 1:
            raise RuntimeError("alloc_reserved without a reservation")
        if not self._free:
            # structurally impossible while every allocation is backed
            # by a reservation — kept as a loud invariant check
            raise RuntimeError("block pool free list empty under "
                               "outstanding reservations")
        self._reserved -= 1
        bid = self._free.pop()
        self._refs[bid] = 1
        self.allocated_total += 1
        return bid

    def try_alloc(self):
        """Reserve-and-materialise one block in a single call, or None
        when the pool cannot cover it (backpressure, never a raise).
        The handoff-import and store-warm paths allocate OUTSIDE any
        admission's worst-case reservation, so each block is its own
        reserve+alloc pair."""
        if not self.reserve(1):
            return None
        return self.alloc_reserved()

    def incref(self, bid: int):  # band-verb: alias
        if self._refs[bid] < 1:
            raise ValueError("incref on free block %d" % bid)
        self._refs[bid] += 1

    def decref(self, bid: int) -> bool:  # band-verb: retire
        """Drop one reference; returns True when the block was freed
        back to the pool."""
        if self._refs[bid] < 1:
            raise ValueError("decref on free block %d" % bid)
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._free.append(int(bid))
            self.freed_total += 1
            return True
        return False

    def refcount(self, bid: int) -> int:
        return int(self._refs[bid])

    def stats(self) -> dict:
        out = {
            "num_blocks": self.num_blocks,
            "block_tokens": self.block_tokens,
            "blocks_in_use": self.blocks_in_use,
            "free_blocks": self.free_blocks,
            "reserved": self._reserved,
            "allocated_total": self.allocated_total,
            "freed_total": self.freed_total,
        }
        if self.block_bytes is not None:
            out["block_bytes"] = self.block_bytes
            out["bytes_in_use"] = self.block_bytes * self.blocks_in_use
        return out
