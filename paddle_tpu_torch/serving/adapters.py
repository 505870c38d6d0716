"""Paged LoRA-style adapter serving (counterpart of
paddle_tpu/serving/adapters.py): many per-tenant q/v weight deltas
batched over ONE base model in the engine's batched steps.

  * `make_adapter` — a random adapter drawn from a numpy RandomState, so
    the JAX package and this one build bit-identical adapters from one
    seed.
  * `AdapterRegistry` — the host-side store of named adapters (per-layer
    stacked A/B arrays for the q and v projections, plus a scalar
    scale), one rank per registry, lock-protected so serving threads
    never race a registration. Carried over unchanged.
  * `AdapterPool` — the engine-side residency manager: stacked
    [P, layers, ...] f32 tensors on the engine's device that the paged
    primitives gather from by a per-slot adapter index
    (`transformer._adapter_qv`), and a `KVBlockAllocator` over P
    one-token "blocks" for residency (ref-counts, free list) with an LRU
    over resident-but-idle adapters. Slot 0 is the pinned zero adapter
    (A = B = 0, scale 0): requests without an adapter ride index 0 and
    decode exactly as the base model. An attach writes one pool slot in
    place (the tensors keep their shapes forever); a pool whose every
    slot is pinned by live requests makes `acquire` return None and the
    request stays queued.

Host bookkeeping only; all pool state is confined to the engine's
scheduler thread, like the block allocator it wraps.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from .kv_blocks import KVBlockAllocator

__all__ = ["AdapterRegistry", "AdapterPool", "make_adapter"]

_BANDS = ("a_q", "b_q", "a_v", "b_v")


def make_adapter(cfg, rank: int, seed: int = 0, scale: float = 1.0,
                 stddev: float = 0.25) -> dict:
    """Random-init one adapter for `cfg` (tests and chip_smoke.py):
    per-layer A [layers, d, r] and B [layers, r, d], both Gaussian and
    non-zero, so a wrong adapter index changes tokens. The same draws,
    in the same order, as the JAX package's `make_adapter`."""
    rng = np.random.RandomState(seed)
    L, d, r = int(cfg.layers), int(cfg.dim), int(rank)

    def g(shape):
        return (stddev * rng.standard_normal(shape)).astype(np.float32)

    return {
        "a_q": g((L, d, r)), "b_q": g((L, r, d)),
        "a_v": g((L, d, r)), "b_v": g((L, r, d)),
        "scale": float(scale),
    }


class AdapterRegistry(object):
    """Named adapter store shared by every engine's `AdapterPool`.
    Register before (or during) serving; reads are lock-protected."""

    def __init__(self, rank: Optional[int] = None):
        self._lock = threading.Lock()
        # name -> {"a_q","b_q","a_v","b_v" np arrays, "scale" float}
        self._adapters: Dict[str, dict] = {}  # guarded-by: _lock
        self.rank = None if rank is None else int(rank)

    def register(self, name: str, adapter: dict):
        """Add (or replace) one adapter. Every adapter shares the
        registry's rank: the device pool is one stacked tensor."""
        a_q = np.asarray(adapter["a_q"], np.float32)
        r = int(a_q.shape[-1])
        with self._lock:
            if self.rank is None:
                self.rank = r
            elif r != self.rank:
                raise ValueError(
                    "adapter %r has rank %d, the registry is rank %d "
                    "(one stacked device pool = one rank)"
                    % (name, r, self.rank))
            self._adapters[name] = {
                "a_q": a_q,
                "b_q": np.asarray(adapter["b_q"], np.float32),
                "a_v": np.asarray(adapter["a_v"], np.float32),
                "b_v": np.asarray(adapter["b_v"], np.float32),
                "scale": float(adapter.get("scale", 1.0)),
            }

    def get(self, name: str) -> dict:
        with self._lock:
            if name not in self._adapters:
                raise KeyError("unknown adapter %r (registered: %r)"
                               % (name, sorted(self._adapters)))
            return self._adapters[name]

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._adapters

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._adapters)


class AdapterPool(object):
    """Device-resident adapter pool for ONE engine: stacked
    [P, layers, ...] f32 tensors on `device` (CUDA by default) that the
    paged primitives gather from by per-slot index, plus the residency
    bookkeeping and an LRU over resident-but-idle adapters. Slot 0 is
    the pinned zero adapter."""

    def __init__(self, cfg, registry: AdapterRegistry, slots: int,
                 rank: Optional[int] = None, device=None):
        P = int(slots)
        if P < 2:
            raise ValueError(
                "adapter_slots must be >= 2 (slot 0 is the pinned "
                "zero adapter)")
        r = registry.rank if rank is None else int(rank)
        if r is None:
            raise ValueError(
                "adapter rank unknown: register an adapter first or "
                "pass adapter_rank")
        self.registry = registry
        self.slots = P
        self.rank = r
        L, d = int(cfg.layers), int(cfg.dim)
        dev = resolve_device(device)
        shapes = {"a_q": (P, L, d, r), "b_q": (P, L, r, d),
                  "a_v": (P, L, d, r), "b_v": (P, L, r, d)}
        # zeros everywhere: every slot starts as (and an evicted slot is
        # unreachable until re-uploaded over) a delta of exact zeros
        self._arrays = {k: torch.zeros(shp, dtype=torch.float32, device=dev)
                        for k, shp in shapes.items()}  # guarded-by: scheduler
        self._arrays["scale"] = torch.zeros(P, dtype=torch.float32,
                                            device=dev)
        # residency accounting IS a block allocator: one slot = one
        # block, refcount 1 = resident only (evictable), > 1 = pinned
        self._alloc = KVBlockAllocator(P, 1)              # guarded-by: scheduler
        self._alloc.reserve(1)
        zero = self._alloc.alloc_reserved()
        if zero != 0:  # the allocator pops ascending ids
            raise RuntimeError("the zero adapter must take pool slot 0")
        self._resident: Dict[str, int] = {}               # guarded-by: scheduler
        self._slot_name: Dict[int, str] = {}              # guarded-by: scheduler
        self._lru: List[str] = []  # oldest first               # guarded-by: scheduler
        self.hits = 0                                     # guarded-by: scheduler
        self.misses = 0                                   # guarded-by: scheduler
        self.evictions = 0                                # guarded-by: scheduler
        self.uploads = 0                                  # guarded-by: scheduler

    # -- device side ----------------------------------------------------
    def device_arrays(self) -> dict:
        """The stacked pool tensors the paged primitives gather from, in
        `transformer._adapter_qv`'s key shape."""
        return self._arrays

    def _upload(self, slot: int, ad: dict):
        # one slot written in place: the pool tensors never change shape
        for k in _BANDS:
            self._arrays[k][slot].copy_(torch.from_numpy(ad[k]))
        self._arrays["scale"][slot] = float(ad["scale"])
        self.uploads += 1

    # -- residency ------------------------------------------------------
    def _touch(self, name: str):
        self._lru.remove(name)
        self._lru.append(name)

    def _evict_idle(self) -> bool:
        """Evict the least-recently-used resident adapter nobody holds
        (refcount == the residency ref alone). False when every resident
        adapter is pinned by a live request."""
        for name in self._lru:
            slot = self._resident[name]
            if self._alloc.refcount(slot) == 1:
                self._alloc.decref(slot)  # frees: residency was last
                del self._resident[name]
                del self._slot_name[slot]
                self._lru.remove(name)
                self.evictions += 1
                return True
        return False

    def acquire(self, name: Optional[str]) -> Optional[int]:
        """Pin one adapter for a request being admitted and return its
        pool slot. None (no adapter) is the zero slot and always
        succeeds. A cold miss pages the adapter in (LRU-evicting an idle
        resident one if the pool is full); when every slot is pinned by
        live requests, returns None and the caller leaves the request
        queued."""
        if name is None:
            self._alloc.incref(0)
            return 0
        slot = self._resident.get(name)
        if slot is not None:
            self._alloc.incref(slot)
            self._touch(name)
            self.hits += 1
            return slot
        ad = self.registry.get(name)  # raises on unknown: caller's bug
        if self._alloc.available < 1 and not self._evict_idle():
            return None  # saturated: every resident adapter is live
        self.misses += 1
        self._alloc.reserve(1)
        slot = self._alloc.alloc_reserved()
        self._upload(slot, ad)
        self._resident[name] = slot
        self._slot_name[slot] = name
        self._lru.append(name)
        self._alloc.incref(slot)  # the request's pin, over residency's
        return slot

    def release(self, slot: int):
        """Drop one request's pin (retirement); the residency ref keeps
        the adapter warm for the next request."""
        self._alloc.decref(slot)

    def detach(self, name: str) -> bool:
        """Evict one adapter now. False when it is not resident or is
        pinned by a live request."""
        slot = self._resident.get(name)
        if slot is None or self._alloc.refcount(slot) != 1:
            return False
        self._alloc.decref(slot)
        del self._resident[name]
        del self._slot_name[slot]
        self._lru.remove(name)
        self.evictions += 1
        return True

    def resident(self) -> List[str]:
        return sorted(self._resident)

    def refcount(self, name: str) -> int:
        slot = self._resident.get(name)
        return 0 if slot is None else self._alloc.refcount(slot)

    def stats(self) -> dict:
        return {
            "slots": self.slots,
            "rank": self.rank,
            "resident": len(self._resident),
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "uploads": self.uploads,
        }
