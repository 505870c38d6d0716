"""Continuous-batching inference serving (counterpart of
paddle_tpu/serving/): a paged KV block pool with per-slot block tables,
prefix reuse by ref-counted block aliasing with copy-on-write, chunked
prefill and one batched decode step per scheduler iteration over the
transformer's paged primitives. See engine.py for the design,
kv_blocks.py for the pool allocator and prefix_cache.py for the trie."""

from .engine import EngineFailed, ServingEngine, ServingHandle
from .integrity import IntegrityError, ServingSentinel
from .kv_blocks import KVBlockAllocator
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache

__all__ = ["ServingEngine", "ServingHandle", "EngineFailed",
           "IntegrityError", "ServingSentinel", "KVBlockAllocator",
           "PrefixCache", "ServingMetrics"]
