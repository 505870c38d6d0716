"""Continuous-batching inference serving (counterpart of
paddle_tpu/serving/): a paged KV block pool with per-slot block tables,
prefix reuse by ref-counted block aliasing with copy-on-write, chunked
prefill, one batched decode step, K-token decode window (with async
dispatch) or speculative verify step per scheduler iteration over the
transformer's paged primitives, quantized KV pools and weights, LoRA
adapters, KV block fingerprints and the durable KV store. See engine.py
for the design, kv_blocks.py for the pool allocator, prefix_cache.py
for the trie, quantization.py for the int8 weights, adapters.py for the
adapter pool, integrity.py for traps and fingerprints, kv_store.py
for the durable tier, fleet.py for the supervised replica fleet
(journal, failover, rollout, canaries), tenancy.py for quotas and fair
queueing, wire.py / frontdoor.py for the TCP front door and loadgen.py
for open-loop load."""

from .adapters import AdapterPool, AdapterRegistry, make_adapter
from .engine import EngineFailed, ServingEngine, ServingHandle
from .integrity import (CANARY_PROMPT, BlockFingerprints, IntegrityError,
                        ServingSentinel, fp_digest, golden_trace)
from .fleet import (DeadlineExceeded, FleetHandle, FleetSaturated,
                    FleetTimeout, RequestCancelled, RequestJournal,
                    RolloutAborted, SchedulerHook, ServingFleet,
                    load_weights, run_fleet_subprocess, save_weights)
from .frontdoor import FrontDoor
from .kv_blocks import KVBlockAllocator
from .kv_store import KVBlockStore, make_block_record, payload_crc
from .metrics import ServingMetrics
from .loadgen import LoadReport, find_knee, run_open_loop, sweep
from .prefix_cache import PrefixCache, PrefixMatch, chain_keys, fold_key
from .quantization import (QuantTensor, dequantize_params, params_bytes,
                           quantize_params)
from .tenancy import (Tenant, TenantQuotaExceeded, TenantRegistry, WFQueue,
                      executor_batch_fn)
from .wire import (ERROR_CODES, MAX_FRAME_BYTES, WireClient, WireError,
                   error_code_for, read_frame, send_frame)

__all__ = ["ServingEngine", "ServingHandle", "EngineFailed",
           "IntegrityError", "ServingSentinel", "BlockFingerprints",
           "golden_trace", "fp_digest", "CANARY_PROMPT",
           "KVBlockAllocator", "PrefixCache", "chain_keys", "fold_key",
           "KVBlockStore", "make_block_record", "payload_crc",
           "AdapterRegistry", "AdapterPool", "make_adapter",
           "ServingMetrics", "QuantTensor", "quantize_params",
           "dequantize_params", "params_bytes", "PrefixMatch",
           "ServingFleet", "FleetHandle", "FleetSaturated",
           "RequestJournal", "DeadlineExceeded", "FleetTimeout",
           "RolloutAborted", "RequestCancelled", "SchedulerHook",
           "save_weights", "load_weights", "run_fleet_subprocess",
           "Tenant",
           "TenantRegistry", "TenantQuotaExceeded", "WFQueue",
           "executor_batch_fn", "FrontDoor", "WireClient", "WireError",
           "ERROR_CODES", "MAX_FRAME_BYTES", "error_code_for",
           "read_frame", "send_frame", "LoadReport", "run_open_loop",
           "sweep", "find_knee"]
