"""Prefix KV pool: a trie of cached prompt-prefix KV blocks shared
across requests (RadixAttention, Zheng et al. 2024, recast for the
slotted static-shape cache).

Heavy serving traffic repeats prompt headers — the same system prompt /
few-shot block leads dozens of concurrent requests — and the baseline
engine recomputed that header's K/V for every admission. The pool turns
the repeat into a device-side copy: completed prefixes are published
back as fixed-size token BLOCKS (one trie node per block, children
keyed by the child block's token tuple), and admission walks the trie
for the longest cached block-chain, `dynamic_update_slice`-copying each
block's K/V into the new slot instead of recomputing it. Fixed block
granularity is the static-shape analogue of the radix tree's
path-compressed edges: no node splitting, ONE compiled copy/extract
shape total (vs per-length shapes), and eviction is block-sized — the
same reasons vLLM's prefix cache hashes fixed blocks.

Pool discipline (the reference's pooled-allocator design,
PoolAllocator/MemoryHandle):
  * token budget — the pool holds at most `token_budget` cached tokens;
    publishing past the budget evicts least-recently-used LEAF blocks
    (a leaf has no children, so evicting it never orphans a longer
    cached chain that extends through it).
  * ref-counted entries — `match()` acquires every matched node; an
    acquired node is skipped by eviction until `release()`, so a block
    serving a live device-copy can never be freed mid-admit. A matched
    chain is root-connected, so acquiring the chain pins every
    ancestor of every acquired node.
  * counters — hits/misses/evictions/tokens-saved, O(1) ints (the same
    no-unbounded-lists rule ServingMetrics follows).

Payloads are OPAQUE to the pool (the paged engine stores PHYSICAL
block ids); the trie, budget, LRU, and ref-count logic are pure host
bookkeeping and unit-testable without a device. Opacity is what makes
quantized pools free here: a published block id names the
payload AND its per-(block, head) scale side-band — both live in the
cache pytree keyed by that id — so an aliasing hit shares the scale
with the payload and the trie never learns storage dtypes exist
(within one engine the pool has exactly one storage dtype; across a
fleet, uniformity is enforced at replica spawn).
"""

from __future__ import annotations

import heapq
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

__all__ = ["PrefixCache", "PrefixMatch", "chain_keys", "fold_key"]


def _fold(acc: int, block) -> int:
    """One chain-key step: crc32 of a block's tokens folded over the
    parent key. The SINGLE definition both sides of affinity routing
    use — `chain_keys` (prompt side) and `PrefixCache.summary` (trie
    side) must produce identical keys or every lookup silently
    misses."""
    return zlib.crc32(np.asarray(block, np.int64).tobytes(), acc)


# public alias: the durable KV store (kv_store.py) keys its records
# with the SAME fold as the trie summary and the router — three users,
# one definition, or lookups silently miss across the tier boundary
fold_key = _fold


def chain_keys(tokens, block_tokens: int) -> List[int]:
    """Chained-crc32 key per whole leading block of `tokens`: key[d]
    identifies the token prefix tokens[:(d+1)*block_tokens] (the crc of
    block d folded over key[d-1]). Two prefixes share key[d] iff they
    share the first d+1 blocks (modulo crc collision — harmless where
    this is used: fleet AFFINITY routing, which only steers load; the
    pool's trie match stays exact). Module-level so the fleet router can
    key a prompt without holding any pool."""
    tokens = np.asarray(tokens).reshape(-1)
    out: List[int] = []
    acc = 0
    for d in range(len(tokens) // int(block_tokens)):
        acc = _fold(acc, tokens[d * block_tokens:(d + 1) * block_tokens])
        out.append(acc)
    return out


class _Node(object):
    __slots__ = ("block", "payload", "children", "parent", "refs", "stamp")

    def __init__(self, block: Tuple[int, ...], payload: Any,
                 parent: Optional["_Node"]):
        self.block = block
        self.payload = payload
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.refs = 0
        self.stamp = 0


class PrefixMatch(object):
    """Result of `PrefixCache.match()`: the longest cached block-chain
    for the probed tokens, ACQUIRED (ref-counted) until `release()`.
    `payloads` lists each matched block's payload in chain order;
    `length` is the matched token count (blocks * block_tokens)."""

    def __init__(self, cache: "PrefixCache", nodes: List[_Node]):
        self._cache = cache
        self._nodes = nodes
        self.length = len(nodes) * cache.block_tokens
        self._released = False

    @property
    def payloads(self) -> List[Any]:
        return [n.payload for n in self._nodes]

    def release(self):
        if self._released:
            return
        self._released = True
        for n in self._nodes:
            n.refs -= 1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


class PrefixCache(object):
    """Trie-keyed pool of cached KV prefix blocks with LRU eviction
    under a token budget. Single-threaded (the serving engine's
    scheduler loop); all bookkeeping is O(blocks)."""

    def __init__(self, token_budget: int, block_tokens: int = 16,
                 on_evict: Optional[Callable[[Any], None]] = None):
        if int(block_tokens) < 1:
            raise ValueError("block_tokens must be >= 1")
        if int(token_budget) < 1:
            raise ValueError("token_budget must be >= 1")
        self.token_budget = int(token_budget)
        self.block_tokens = int(block_tokens)
        # called with each evicted node's payload BEFORE it is dropped.
        # The paged engine publishes physical block IDS as payloads and
        # uses this hook to decref them in the KV pool — eviction is how
        # a trie-held block's HBM returns to the allocator.
        self._on_evict = on_evict
        self._root = _Node((), None, None)
        self._nodes: Dict[_Node, None] = {}  # every non-root node
        self._clock = 0
        # O(1) counters (no per-request history)
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.tokens_saved = 0
        self.inserted_blocks = 0
        self.size_tokens = 0

    # -- internals ------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _block_of(self, tokens, d: int) -> Tuple[int, ...]:
        B = self.block_tokens
        return tuple(int(t) for t in tokens[d * B:(d + 1) * B])

    # -- lookup ---------------------------------------------------------
    def match(self, tokens, record=True) -> PrefixMatch:  # band-verb: alias
        """Longest cached block-chain prefix of `tokens` (block
        granularity: a partial trailing block never matches). Acquires
        every matched node — call `release()` (or use as a context
        manager) once the copies are dispatched. With `record` (the
        default) counts one hit (length > 0) or miss per call and
        LRU-stamps the chain; `record=False` is a pure PROBE — the
        engine's admission may retry a block-starved request every
        scheduler step, and retries must not inflate hit/miss stats or
        perturb eviction order (call `record_hit`/`record_miss` once
        the admission actually resolves)."""
        tokens = np.asarray(tokens).reshape(-1)
        node, nodes = self._root, []
        for d in range(len(tokens) // self.block_tokens):
            child = node.children.get(self._block_of(tokens, d))
            if child is None:
                break
            nodes.append(child)
            node = child
        for n in nodes:
            n.refs += 1
        m = PrefixMatch(self, nodes)
        if record:
            if nodes:
                self.record_hit(m)
            else:
                self.record_miss()
        return m

    def record_hit(self, m: PrefixMatch):
        """Commit a probed match as an actual use: LRU-stamp the chain
        and count the hit + saved tokens ONCE (per admission, not per
        retry)."""
        stamp = self._tick()
        for n in m._nodes:
            n.stamp = stamp
        self.hits += 1
        self.tokens_saved += m.length

    def record_miss(self):
        self.misses += 1

    def idle_payloads(self) -> List[Any]:
        """Payloads of every node no in-flight match holds — the
        engine's reclaim-gain probe: before evicting shareable chains
        toward an admission, it checks these payloads' pool refcounts
        to see whether eviction can free enough blocks AT ALL."""
        return [n.payload for n in self._nodes if n.refs == 0]

    # -- publication ----------------------------------------------------
    def publish(self, tokens, n_blocks: int,
                make_payload: Callable[[int], Any]) -> int:
        """Insert the first `n_blocks` blocks of `tokens` into the trie.
        `make_payload(d)` is called ONLY for blocks not already cached
        (the extract cost is paid once per novel block, not per
        request). Returns the number of new blocks; may evict LRU
        leaves to stay under the token budget."""
        tokens = np.asarray(tokens).reshape(-1)
        if n_blocks * self.block_tokens > len(tokens):
            raise ValueError("publish needs n_blocks*block_tokens <= len")
        stamp = self._tick()
        node, new = self._root, 0
        for d in range(int(n_blocks)):
            blk = self._block_of(tokens, d)
            child = node.children.get(blk)
            if child is None:
                child = _Node(blk, make_payload(d), node)
                node.children[blk] = child
                self._nodes[child] = None
                self.size_tokens += self.block_tokens
                self.inserted_blocks += 1
                new += 1
            child.stamp = stamp
            node = child
        self._evict_to_budget()
        return new

    def _evict_to_budget(self):
        if self.size_tokens <= self.token_budget:
            return
        self._evict_lru(lambda n: self.size_tokens > self.token_budget)

    def reclaim(self, n_blocks: int) -> int:
        """Evict up to `n_blocks` LRU unreferenced leaf blocks
        REGARDLESS of the token budget, returning the count actually
        evicted. The paged engine calls this when an admission needs
        pool blocks the trie is idly holding: shareability is worth
        less than admitting the next request (vLLM's cached-block
        reclaim policy). Acquired chains stay pinned as ever."""
        if n_blocks <= 0:
            return 0
        return self._evict_lru(lambda n: n < n_blocks)

    def _evict_lru(self, more) -> int:  # band-verb: retire
        # one pass builds the LRU heap of currently-evictable leaves;
        # the cascade then costs O(log n) per eviction (evicting a leaf
        # may expose its parent as the next candidate) — admissions
        # wait on this loop, so no full rescan per victim. `more`
        # receives the running eviction count and says whether to keep
        # going (budget pressure or an explicit reclaim quota).
        heap = [
            (n.stamp, i, n) for i, n in enumerate(self._nodes)
            if not n.children and n.refs == 0
        ]
        heapq.heapify(heap)
        tick = len(heap)
        evicted = 0
        while more(evicted) and heap:
            stamp, _, victim = heapq.heappop(heap)
            if victim not in self._nodes or victim.children \
                    or victim.refs > 0 or victim.stamp != stamp:
                continue  # stale heap entry
            parent = victim.parent
            del parent.children[victim.block]
            del self._nodes[victim]
            if self._on_evict is not None:
                self._on_evict(victim.payload)
            victim.payload = None
            self.size_tokens -= self.block_tokens
            self.evictions += 1
            evicted += 1
            if parent is not self._root and not parent.children \
                    and parent.refs == 0:
                tick += 1
                heapq.heappush(heap, (parent.stamp, tick, parent))
        # heap drained with pinned entries left: honestly over budget
        return evicted

    # -- reporting ------------------------------------------------------
    def summary(self) -> Set[int]:
        """Host-only routing digest: the chain key (see `chain_keys`) of
        every cached block-chain prefix. A fleet front door matches a
        prompt's chain keys against each replica's summary to find the
        replica whose pool holds the longest prefix — without touching
        the trie from another thread (the summary is rebuilt by the
        replica's own thread and handed over as an immutable set).
        O(blocks) walk; the pool is budget-bounded so this stays small."""
        out: Set[int] = set()
        stack: List[Tuple[_Node, int]] = [(self._root, 0)]
        while stack:
            node, acc = stack.pop()
            for child in node.children.values():
                key = _fold(acc, child.block)
                out.add(key)
                stack.append((child, key))
        return out

    def __len__(self) -> int:
        return len(self._nodes)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "evictions": self.evictions,
            "tokens_saved": self.tokens_saved,
            "inserted_blocks": self.inserted_blocks,
            "size_tokens": self.size_tokens,
            "token_budget": self.token_budget,
            "block_tokens": self.block_tokens,
            "blocks": len(self._nodes),
        }
