"""Continuous-batching inference serving (counterpart of
paddle_tpu/serving/): a paged KV block pool with per-slot block tables,
prefix reuse by ref-counted block aliasing with copy-on-write, chunked
prefill, one batched decode (or speculative verify) step per scheduler
iteration over the transformer's paged primitives, and quantized KV
pools and weights. See engine.py for the design, kv_blocks.py for the
pool allocator, prefix_cache.py for the trie and quantization.py for
the int8 weights."""

from .engine import EngineFailed, ServingEngine, ServingHandle
from .integrity import IntegrityError, ServingSentinel
from .kv_blocks import KVBlockAllocator
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .quantization import (QuantTensor, dequantize_params, params_bytes,
                           quantize_params)

__all__ = ["ServingEngine", "ServingHandle", "EngineFailed",
           "IntegrityError", "ServingSentinel", "KVBlockAllocator",
           "PrefixCache", "ServingMetrics", "QuantTensor",
           "quantize_params", "dequantize_params", "params_bytes"]
