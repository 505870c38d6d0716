"""Continuous-batching serving engine over the paged KV block pool
(counterpart of paddle_tpu/serving/engine.py).

One engine serves many concurrent requests of a transformer LM:

  * Paged KV block pool — each layer's cache is a pool of
    `kv_block_tokens`-token blocks [NB, Bt, H, Dh]; each slot owns a
    block-table row mapping logical depth to physical blocks.
    Admission RESERVES a request's worst case (ceil((T0+max_new)/Bt)
    blocks) so decode never deadlocks; blocks are ALLOCATED on demand
    as the sequence grows, and retirement frees them plus the
    unreached tail (kv_blocks.py).
  * Prefix reuse by table aliasing — finished prompt prefixes publish
    their physical block ids into a trie (prefix_cache.py); a hit
    writes those ids into the new slot's table (ref-counted, zero-copy).
    A shared block the suffix must write into is COPY-ON-WRITE
    privatised first.
  * Chunked prefill — the uncached suffix runs through
    `paged_prefill_chunk` in chunks of `prefill_chunk_tokens`, padded to
    power-of-two buckets, interleaved with batched decode (a pending
    slot advances at most one chunk per step).
  * One batched decode per step — `paged_decode_step` advances every
    live slot at its own position; greedy or sampled per slot with the
    `fold_in(PRNGKey(seed), token_index)` key schedule (utils/prng.py,
    bit-exact with jax.random), so sampled output depends only on
    (seed, index), never on slot or batch.
  * Iteration-level scheduling — a slot retires the step its request
    emits EOS or exhausts its budget and refills from the FCFS queue; a
    saturated pool QUEUES admissions (backpressure) instead of raising.
  * Request SLO — `deadline_at` expires a request at the next queue hop;
    `resume_tokens` turns already-emitted tokens into prefill context;
    `cancel(rid)` claws a request back.
  * Integrity traps (default on) — every decode and final prefill chunk
    also computes a per-slot non-finite trap and a max-|logit| scalar;
    a tripped slot raises `IntegrityError` instead of emitting.
  * Self-drafting speculative decoding — with `spec_draft_len` = K, each
    step verifies a K-token window per slot (the pending token plus K-1
    drafts continuing the context's last bigram from its previous
    occurrence) in one `paged_verify_step`, and emits the model's own
    tokens up to the first draft mismatch plus the bonus token. Greedy
    output is exactly the plain path's; sampled output too (window row
    i samples with the key of token index counts+i).
  * Quantized serving — `kv_quant` ("int8" | "fp8") stores the KV pool
    as codes with per-(physical block, head) scales, quantized at the
    scatter (decode and verify commit a block's scale from its opening
    row, so quantized spec decode emits the quantized plain path's
    tokens) and dequantized in the paged kernel; `weight_quant="int8"`
    keeps the parameters as per-tensor int8 and dequantizes them at the
    start of every step (once per decode window).
  * Decode windows and async dispatch — `decode_window` = K runs K
    decode iterations per dispatch, all on the device: each iteration
    samples on the same fold_in(seed, count) schedule, retires slots
    that hit EOS or their budget (`transformer.decode_window_retire`;
    their later writes park, their lanes emit -1) and stacks its traps
    [K, S], so the host syncs once per K tokens. `async_dispatch`
    enqueues window N+1 off window N's device outputs before syncing N;
    a host event that dirties a device-advanced band breaks the chain.
    A steady chained dispatch uploads nothing and reads nothing back.
  * LoRA adapters — `adapter_registry` with `adapter_slots` /
    `adapter_rank`: a device pool of stacked q/v deltas
    (serving/adapters.py) gathered per slot by the `aidx` band inside
    the same batched steps; `submit(adapter=)` resolves or refuses at
    once; adapter requests never alias or publish the prefix trie.
  * KV fingerprints — `kv_fingerprints=True` commits a per-block
    checksum when a block closes (publish), verifies it when another
    request re-opens the aliased block, and drops it when the block is
    freed: a flipped block cannot serve a prefix hit.
  * Durable KV store — `kv_store` (serving/kv_store.py): closed blocks
    spill as self-describing records at publish; `submit(handoff=)`
    imports a request's finished prefix after fingerprint verification
    (re-prefill is the counted fallback); `kv_store_warm=True` (or
    `warm_from_store()`) restores the store's chains into the trie.

Attention goes through `paged_kernel="fused"` by default on every
device: on CUDA tensors the Hopper paged-attention kernel, on CPU
tensors its plain PyTorch version. "gather" runs the reference's
gathered-view math instead. The engine runs eagerly: the JAX package's
one-compiled-step discipline becomes plain in-place cache updates, and
its per-step side-band arrays stay device-resident between steps,
re-uploaded only when a scheduler event dirties them.

Correctness bar (tested against the JAX engine on the CPU): the same
trace gives the same tokens per request, greedy and sampled, and the
same prefix hits, copy-on-writes and block residency.

Every constructor knob and `submit` argument of the reference is taken
except four constructor arguments: `donate` (the reference donates its
cache buffers to each compiled step; this cache is updated in place,
so there is nothing to donate), `prefix_block_tokens` (the reference's
older name for `kv_block_tokens`), and the fleet's `scheduler_hook`
and `weights_version`, which wait for the port of serving/fleet.py.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .. import resolve_device
from ..distributed import fault_injection as _fi
from ..models import transformer as tlm
from ..parallel.kernel_utils import raw_bytes
from ..utils import prng
from .adapters import AdapterPool
from .integrity import (_FP_RTOL, BlockFingerprints, IntegrityError,
                        ServingSentinel)
from .kv_blocks import KVBlockAllocator
from .kv_store import make_block_record, payload_crc
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache, chain_keys
from .quantization import dequantize_params, quantize_params

__all__ = ["ServingEngine", "ServingHandle", "EngineFailed",
           "IntegrityError"]

# per-slot side-bands the decode step reads; kept device-resident and
# re-uploaded only when a scheduler event dirties one
_BANDS = ("tok", "pos", "alive", "temps", "counts", "base_keys", "tables",
          "limits", "aidx", "eos")

# bands the decode window ADVANCES on the device: a host event that
# dirties one of these between dispatch and sync (admission,
# retirement, cancel, expiry) means the device copies no longer carry
# host truth, so the async chain must break and re-upload. The other
# bands are host truth only (the device never writes them).
_DEVICE_ADVANCED = frozenset(("tok", "pos", "alive", "counts"))


def bucket_pow2(m: int, floor: int = 8) -> int:
    """Smallest power of two >= m (at least `floor`): the prefill chunk
    pad length, so chunk shapes stay O(log max_len) (a copy of
    paddle_tpu/fluid/core/kernels_sequence.bucket_pow2)."""
    b = floor
    while b < m:
        b *= 2
    return b


def _dtype_name(t) -> str:
    """A tensor's dtype as the KV store's meta rows spell it (numpy's
    names: "float32", "bfloat16", "int8", "float8_e4m3fn")."""
    return str(t.dtype).replace("torch.", "")


def _row_bytes(t):
    """One contiguous block row of a pool band as flat uint8."""
    return t.reshape(-1).view(torch.uint8)


class EngineFailed(RuntimeError):
    """The engine died with requests pending. Raised by
    `ServingHandle.result()` instead of blocking forever, and by
    `ServingEngine.step()` on every call after the failure (a step that
    died mid-way leaves the in-place cache in an unknown state).
    `replica` names the failing replica when the engine serves inside a
    fleet."""

    def __init__(self, msg: str, replica=None):
        super().__init__(msg)
        self.replica = replica


class ServingHandle(object):
    """Per-request future, filled in as the engine steps. `result()`
    drives the owning engine until this request completes. A handle
    submitted with `resume_tokens` carries tokens an earlier incarnation
    already emitted: they become prefill context, only the remainder is
    decoded, and the sampling key schedule continues at index
    `resume_len`. `tokens` holds only the newly generated tokens;
    `result()` returns the full sequence. `adapter` names the request's
    adapter (None = the base model); `handoff` is a durable-KV package
    (the finished prefix's store records), judged at admission, whose
    outcome lands in `handoff_imported` / `handoff_fallback` /
    `handoff_outcome`."""

    def __init__(self, engine, rid, prompt, max_new_tokens, temperature,
                 eos_id, seed, publish_len, deadline_at=None,
                 resume_tokens=None, adapter=None, handoff=None):
        self._engine = engine
        self.rid = rid
        self.prompt = prompt  # np.int32 [T0] — the original prompt
        self.resume_tokens = np.asarray(
            resume_tokens if resume_tokens is not None else [], np.int32)
        self.resume_len = int(self.resume_tokens.shape[0])
        self.full_prompt = (
            np.concatenate([prompt, self.resume_tokens])
            if self.resume_len else prompt)
        self.total_new_tokens = int(max_new_tokens)
        self.max_new_tokens = int(max_new_tokens) - self.resume_len
        self.temperature = float(temperature)
        self.eos_id = eos_id
        self.seed = seed
        # how many leading prompt tokens may be published back to the
        # prefix pool (None = the whole prompt)
        self.publish_len = publish_len
        self.deadline_at = deadline_at  # absolute time.monotonic()
        self.adapter = adapter
        self.handoff = handoff
        self.handoff_imported = 0       # tokens imported clean
        self.handoff_fallback = False   # any re-prefill shortfall
        self.handoff_outcome = None     # set once the package is judged
        self.tokens: List[int] = []  # generated tokens (may include eos)
        self.done = False
        # 'eos' | 'budget' | 'expired' | 'cancelled'
        self.finish_reason: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.submit_t = time.monotonic()
        self.queue_wait_s: Optional[float] = None
        self.ttft_s: Optional[float] = None

    def result(self) -> np.ndarray:
        """Step the engine until done; returns prompt, resumed tokens
        and generated tokens. Raises `EngineFailed` if the engine died
        with this request pending."""
        while not self.done:
            if self.error is not None:
                raise self.error
            if not self._engine.step():
                raise RuntimeError(
                    "engine made no progress but request %r is not done"
                    % self.rid)
        return np.concatenate(
            [self.full_prompt, np.asarray(self.tokens, np.int32)])


class ServingEngine(object):
    """Continuous-batching engine over the transformer's paged
    primitives. Knobs: `max_slots` (concurrent requests in the batched
    decode), `max_len` (per-request position cap, bounded by the
    positional table), `min_bucket` (smallest prefill pad length),
    `max_prefills_per_step` (total prefill chunks per step; None = every
    pending slot advances one chunk), `prefill_chunk_tokens` (max tokens
    per chunk; None = the whole suffix), `kv_block_tokens` (block
    granularity of the pool, the prefix trie and copy-on-write),
    `kv_pool_blocks` (pool size; default max_slots x ceil(max_len /
    Bt)), `prefix_cache_tokens` (token budget of the prefix trie;
    None/0 disables reuse),
    `paged_kernel` ("fused" | "gather"), `integrity_traps`,
    `integrity_spike_factor`, `replica_id` and `fault_injector` as in
    the reference; `spec_draft_len` (verify window K; None or < 2 = plain
    decode), `kv_quant` ("none" | "int8" | "fp8") and `weight_quant`
    (None | "int8"); `decode_window` (K decode iterations per dispatch;
    None or 1 with `async_dispatch=False` is the one-token step) and
    `async_dispatch`; `adapter_registry`, `adapter_slots` (pool slots,
    slot 0 the zero adapter) and `adapter_rank`; `kv_fingerprints`;
    `kv_store` and `kv_store_warm`. `params` must already live on
    `device` (CUDA by default)."""

    def __init__(self, params, cfg, max_slots=8, max_len=None,
                 min_bucket=8, max_prefills_per_step=None,
                 prefill_chunk_tokens=None, prefix_cache_tokens=None,
                 kv_block_tokens=None, kv_pool_blocks=None,
                 spec_draft_len=None, replica_id=None,
                 fault_injector=None, adapter_registry=None,
                 adapter_slots=8, adapter_rank=None,
                 paged_kernel="fused", kv_quant="none", weight_quant=None,
                 integrity_traps=True, kv_fingerprints=False,
                 integrity_spike_factor=None, kv_store=None,
                 kv_store_warm=False, decode_window=None,
                 async_dispatch=False, device=None):
        if spec_draft_len is not None and int(spec_draft_len) < 0:
            raise ValueError("spec_draft_len must be >= 0 or None")
        # K < 2 means no drafts to verify: the plain decode step
        self.spec_draft_len = (
            int(spec_draft_len) if spec_draft_len and int(spec_draft_len) >= 2
            else None)
        dw = 1 if decode_window is None else int(decode_window)
        if dw < 1:
            raise ValueError("decode_window must be >= 1 or None")
        self.decode_window = dw
        self.async_dispatch = bool(async_dispatch)
        if self.spec_draft_len is not None and (
                dw > 1 or self.async_dispatch):
            raise ValueError(
                "spec_draft_len composes with neither decode_window>1 "
                "nor async_dispatch: speculative acceptance is a host "
                "decision after every verify step — run spec with "
                "decode_window=1 and async_dispatch=False")
        tlm._kv_quant_check(kv_quant)
        self.kv_quant = kv_quant
        if weight_quant not in (None, "int8"):
            raise ValueError("weight_quant must be None or 'int8' (got %r)"
                             % (weight_quant,))
        self.weight_quant = weight_quant
        if paged_kernel not in ("fused", "gather"):
            raise ValueError("paged_kernel must be 'fused' or 'gather' "
                             "(got %r)" % (paged_kernel,))
        self.device = resolve_device(device)
        self._check_params_device(params)
        self._params = params
        self._cfg = cfg
        S = int(max_slots)
        if S < 1:
            raise ValueError("max_slots must be >= 1")
        self.max_slots = S
        # the positional table bounds every position
        L = min(int(max_len or cfg.max_len), int(params["pos"].shape[0]))
        self.max_len = L
        self.min_bucket = int(min_bucket)
        if max_prefills_per_step is not None and max_prefills_per_step < 1:
            raise ValueError("max_prefills_per_step must be >= 1 or None")
        self.max_prefills_per_step = max_prefills_per_step
        if prefill_chunk_tokens is not None and prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1 or None")
        self.prefill_chunk_tokens = prefill_chunk_tokens
        Bt = 16 if kv_block_tokens is None else int(kv_block_tokens)
        if Bt < 1:
            raise ValueError("kv_block_tokens must be >= 1")
        self.kv_block_tokens = Bt
        self.blocks_per_slot = -(-L // Bt)  # table row width
        NB = (S * self.blocks_per_slot if kv_pool_blocks is None
              else int(kv_pool_blocks))
        if NB < 1:
            raise ValueError("kv_pool_blocks must be >= 1")
        self.num_kv_blocks = NB
        self.paged_kernel = paged_kernel
        self.integrity_traps = bool(integrity_traps)
        if integrity_spike_factor is not None \
                and float(integrity_spike_factor) <= 1.0:
            raise ValueError("integrity_spike_factor must be > 1 or None")
        if integrity_spike_factor is not None and not self.integrity_traps:
            raise ValueError(
                "integrity_spike_factor needs integrity_traps=True (the "
                "spike detector observes the trap reduction's magnitude "
                "scalar)")
        self._sentinel = ServingSentinel(
            spike_factor=integrity_spike_factor)  # guarded-by: scheduler
        if kv_fingerprints and not prefix_cache_tokens:
            # fingerprints commit at trie publish and verify at aliased
            # re-open: with no prefix cache neither point exists
            raise ValueError(
                "kv_fingerprints needs the prefix cache (pass "
                "prefix_cache_tokens=): fingerprints commit at trie "
                "publish and verify at aliased re-open — with no "
                "cache neither audit point ever runs")
        self._fp: Optional[BlockFingerprints] = (
            BlockFingerprints() if kv_fingerprints else None)  # guarded-by: scheduler
        self.metrics = ServingMetrics(S)
        self.metrics.paged_kernel = paged_kernel
        self.metrics.kv_quant = kv_quant
        self.metrics.weight_quant = weight_quant
        self.metrics.spec = self.spec_draft_len is not None
        self.metrics.block_fp = self._fp
        self.metrics.kv_blocks_total = NB
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        self.kv_block_bytes = tlm.kv_block_bytes(
            cfg.layers, cfg.heads, cfg.dim // cfg.heads, Bt, kv_quant,
            act_itemsize=itemsize)
        self._alloc = KVBlockAllocator(
            NB, Bt, block_bytes=self.kv_block_bytes)  # guarded-by: scheduler
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache_tokens:
            # evictions go through _decref_block: a block eviction frees
            # drops its fingerprint with it
            self.prefix_cache = PrefixCache(
                int(prefix_cache_tokens), block_tokens=Bt,
                on_evict=self._decref_block)
            self.metrics.prefix_cache = self.prefix_cache
        # the adapter pool: slot 0 is the zero adapter, so requests
        # without one are exact no-ops
        self._adapter_pool: Optional[AdapterPool] = None  # guarded-by: scheduler
        if adapter_registry is not None:
            self._adapter_pool = AdapterPool(
                cfg, adapter_registry, adapter_slots, rank=adapter_rank,
                device=self.device)
            self.metrics.adapter_pool = self._adapter_pool
        self._cache = tlm.init_paged_kv_cache(cfg, NB, Bt, dtype=cfg.dtype,
                                              kv_quant=kv_quant,
                                              device=self.device)
        if weight_quant is not None:
            # quantized once; the caller's tree stays theirs, the
            # engine's resident copy is int8 + per-tensor scales
            self._params = quantize_params(params)
        # host-side truth of the per-slot side-bands; device copies are
        # kept across steps and re-uploaded only when dirtied. All
        # scheduler state is confined to the thread driving step() and
        # submit() (the engine has no background loop).
        self._tok = np.zeros(S, np.int32)     # guarded-by: scheduler
        self._pos = np.zeros(S, np.int32)     # guarded-by: scheduler
        self._alive = np.zeros(S, bool)       # guarded-by: scheduler
        self._temps = np.zeros(S, np.float32)  # guarded-by: scheduler
        self._counts = np.zeros(S, np.int32)  # guarded-by: scheduler
        # PRNG keys as int64 pairs of uint32 words (utils/prng.py)
        self._base_keys = np.zeros((S, 2), np.int64)  # guarded-by: scheduler
        # per-slot block table (logical depth -> physical block id; -1 =
        # not yet allocated)
        self._tables = np.full((S, self.blocks_per_slot), -1,
                               np.int32)      # guarded-by: scheduler
        # per-slot position limit (T0 + max_new): verify rows at or past
        # it park their writes, and the decode window retires at it
        self._limits = np.zeros(S, np.int32)  # guarded-by: scheduler
        # per-slot adapter-pool slot (0 = the zero adapter) and EOS id
        # (-1 = none; the decode window judges EOS on the device)
        self._aidx = np.zeros(S, np.int32)    # guarded-by: scheduler
        self._eos = np.full(S, -1, np.int32)  # guarded-by: scheduler
        self._n_alloc = np.zeros(S, np.int32)  # table entries >= 0  # guarded-by: scheduler
        self._reserved_tail = np.zeros(S, np.int32)  # guarded-by: scheduler
        self._dev: Dict[str, Any] = {}        # guarded-by: scheduler
        self._dirty = set(_BANDS)             # guarded-by: scheduler
        self._slot_req: List[Optional[ServingHandle]] = [None] * S  # guarded-by: scheduler
        # per-slot chunked-prefill cursors + FCFS order of pending slots
        self._prefill_state: Dict[int, dict] = {}  # guarded-by: scheduler
        self._prefill_q: collections.deque = collections.deque()  # guarded-by: scheduler
        # per-slot self-drafting index (spec decode): the context tokens,
        # a bigram -> end-of-last-occurrence map kept current per emitted
        # token, and the tail bigram's PREVIOUS occurrence
        self._spec_ctx: Dict[int, dict] = {}  # guarded-by: scheduler
        self._queue: collections.deque = collections.deque()  # guarded-by: scheduler
        self._next_rid = 0                    # guarded-by: scheduler
        # any request ever carried a deadline -> the per-step expiry
        # sweep runs; stays False (zero hot-path cost) otherwise
        self._deadlines = False               # guarded-by: scheduler
        # ONE decode function per engine: the window engine never runs
        # the one-token step, and the one-token engine never builds the
        # window
        self._use_window = dw > 1 or self.async_dispatch
        self._window_fn = (self._make_decode_window() if self._use_window
                           else None)
        # the one dispatched-not-yet-synced window (async dispatch);
        # sync mode never leaves one pending
        self._inflight: Optional[dict] = None  # guarded-by: scheduler
        self.replica_id = replica_id
        self._failed: Optional[EngineFailed] = None  # guarded-by: scheduler
        # fault-injection tick source for step(): an explicit injector,
        # or (resolved on the first step) the process-wide default when
        # PADDLE_FAULT is set, else an inert one
        self._injector = fault_injector       # guarded-by: scheduler
        # the durable KV tier: closed blocks spill to it at publish;
        # handoff imports and warm starts read from it
        if kv_store is not None and int(kv_store.block_tokens) != Bt:
            raise ValueError(
                "kv_store block geometry mismatch: store has "
                "block_tokens=%d, engine has %d — records would never "
                "align with the trie chain keys"
                % (int(kv_store.block_tokens), Bt))
        if kv_store is not None and self.prefix_cache is None:
            raise ValueError(
                "kv_store needs the prefix cache (pass "
                "prefix_cache_tokens=): blocks spill at trie publish "
                "and warm-start restores into the trie")
        self._kv_store = kv_store             # thread: shared (store locks itself)
        self.metrics.kv_store = kv_store
        if kv_store is not None and kv_store_warm:
            self.warm_from_store()

    def _check_params_device(self, params):
        want = self.device
        stack = [params]
        while stack:
            x = stack.pop()
            if isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, (list, tuple)):
                stack.extend(x)
            elif x.device.type != want.type or (  # tensor or QuantTensor
                    want.index is not None and x.device.index != want.index):
                raise ValueError(
                    "params live on %s but the engine runs on %s: build "
                    "them with device=%r" % (x.device, want, str(want)))

    # ------------------------------------------------------------------
    # model steps
    # ------------------------------------------------------------------
    def _step_params(self):
        """The parameters a step runs with: int8 weights dequantize here,
        first thing in every decode, verify and chunk step."""
        if self.weight_quant is None:
            return self._params
        return dequantize_params(self._params)

    def _decode_step(self, sample_rows):
        """One batched decode over every slot. Dead slots park their
        write past the table span (block NB after `_phys_rows`), so a
        retired slot never dirties a block a future request claims.
        Returns device tensors (next token, pos + live, counts + live,
        trap, max-|logit|)."""
        Lv = self.blocks_per_slot * self.kv_block_tokens
        tables, tok = self._band("tables"), self._band("tok")
        pos, alive = self._band("pos"), self._band("alive")
        counts = self._band("counts")
        write_pos = torch.where(alive, pos, torch.full_like(pos, Lv))
        logits, _ = tlm.paged_decode_step(
            self._step_params(), tok, write_pos, tables, self._cache,
            self._cfg, kernel=self.paged_kernel, kv_quant=self.kv_quant,
            **self._adapter_args(self._band("aidx")))
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        if len(sample_rows):
            # only the live sampled rows draw: their tokens depend on
            # (seed, count) alone, exactly as in the reference's
            # vmapped fold_in + categorical
            rows = torch.as_tensor(sample_rows, device=self.device)
            keys = prng.fold_in(self._band("base_keys")[rows], counts[rows])
            t = self._band("temps")[rows]
            picked = prng.categorical(keys, logits[rows].float() / t[:, None])
            nxt[rows] = picked.to(torch.int32)
        trap, scale = self._traps(logits, alive)
        live = alive.to(torch.int32)
        return nxt, pos + live, counts + live, trap, scale

    def _verify_step(self, window, sample_rows):
        """One batched speculative verify: every slot's K-token window
        [S, K] written into its paged cache and attended in one
        `paged_verify_step`. Dead slots and rows at or past a request's
        limit park their writes. Returns device tensors (the model's
        candidate after each window prefix [S, K], the per-slot trap,
        max-|logit|)."""
        K = self.spec_draft_len
        Lv = self.blocks_per_slot * self.kv_block_tokens
        pos, alive = self._band("pos"), self._band("alive")
        rows = pos[:, None] + torch.arange(K, device=self.device)[None, :]
        ok = alive[:, None] & (rows < self._band("limits")[:, None])
        wpos = torch.where(ok, rows, torch.full_like(rows, Lv))
        logits, _ = tlm.paged_verify_step(
            self._step_params(), self._cache, window, pos, wpos,
            self._band("tables"), self._cfg, kernel=self.paged_kernel,
            kv_quant=self.kv_quant, **self._adapter_args(self._band("aidx")))
        cand = torch.argmax(logits, dim=-1).to(torch.int32)
        if len(sample_rows):
            # window row i samples token index counts + i: the plain
            # path's fold_in schedule, so sampled output is spec-invariant
            rows_t = torch.as_tensor(sample_rows, device=self.device)
            idx = self._band("counts")[rows_t][:, None] + torch.arange(
                K, device=self.device)[None, :]
            keys = prng.fold_in(self._band("base_keys")[rows_t][:, None],
                                idx)
            t = self._band("temps")[rows_t]
            picked = prng.categorical(
                keys, logits[rows_t].float() / t[:, None, None])
            cand[rows_t] = picked.to(torch.int32)
        if not self.integrity_traps:
            return cand, None, None
        # any corrupt row in a slot's window trips the slot
        trap = tlm.logits_trap(logits).any(dim=-1) & alive
        return cand, trap, tlm.logit_amax(logits, alive)

    def _make_decode_window(self):
        """The K-token decode window: K iterations of the one-token step's
        body, all on the device. Each iteration writes every slot's
        pending token (parked lanes write to position Lv, past the
        table: `_RowWriter` drops them), picks greedy or sampled next
        tokens on the same fold_in(base_key, count) schedule (counts
        advance per live iteration, so sampled tokens do not depend on
        K; sampled rows come from the device bands, so a dispatch
        uploads nothing), then applies `decode_window_retire`: a slot
        hitting EOS or its budget emits that token and parks. Dead lanes
        emit -1. Traps stack per iteration ([K, S], scales [K]), so a
        trip in iteration j poisons only tokens >= j. int8 weights
        dequantize once per window. Returns the advanced device bands
        (tok, pos, alive, counts) and one flat int32 tensor the host
        reads in a single copy: rows [2K+4, S] of the emitted tokens
        [K, S], the four bands and the traps [K, S], then the K scales'
        f32 bits (traps and scales are zeros with traps off)."""
        cfg, K = self._cfg, self.decode_window
        Lv = self.blocks_per_slot * self.kv_block_tokens
        kernel, kv_quant = self.paged_kernel, self.kv_quant
        traps_on = self.integrity_traps

        def _window(tables, tok, pos, alive, temps, counts, base_keys,
                    limits, eos, aidx):
            params = self._step_params()
            adapters = self._adapter_args(aidx)
            sampled = temps > 0
            safe_t = torch.where(sampled, temps, torch.ones_like(temps))
            toks, traps, scales = [], [], []
            for _ in range(K):
                write_pos = torch.where(alive, pos,
                                        torch.full_like(pos, Lv))
                logits, _ = tlm.paged_decode_step(
                    params, tok, write_pos, tables, self._cache, cfg,
                    kernel=kernel, kv_quant=kv_quant, **adapters)
                greedy = torch.argmax(logits, dim=-1).to(torch.int32)
                keys = prng.fold_in(base_keys, counts)
                drawn = prng.categorical(
                    keys, logits.float() / safe_t[:, None]).to(torch.int32)
                nxt = torch.where(sampled, drawn, greedy)
                if traps_on:
                    traps.append(tlm.logits_trap(logits) & alive)
                    scales.append(tlm.logit_amax(logits, alive))
                toks.append(torch.where(alive, nxt,
                                        torch.full_like(nxt, -1)))
                live = alive.to(torch.int32)
                nalive, npos = tlm.decode_window_retire(
                    alive, nxt, pos, limits, eos)
                tok = torch.where(alive, nxt, tok)
                counts = counts + live
                pos, alive = npos, nalive
            if traps_on:
                trap_rows = torch.stack(traps).to(torch.int32)
                bits = torch.stack(scales).float().view(torch.int32)
            else:
                trap_rows = torch.zeros((K, tok.shape[0]), dtype=torch.int32,
                                        device=tok.device)
                bits = torch.zeros(K, dtype=torch.int32, device=tok.device)
            ints = torch.cat([torch.stack(toks), tok[None], pos[None],
                              alive.to(torch.int32)[None], counts[None],
                              trap_rows])
            return (tok, pos, alive, counts), torch.cat(
                [ints.reshape(-1), bits])

        return _window

    def _traps(self, logits, mask=None):
        if not self.integrity_traps:
            return None, None
        trap = tlm.logits_trap(logits)
        if mask is not None:
            trap = trap & mask
        return trap, tlm.logit_amax(logits, mask)

    def _cow(self, dst: int, src: int):  # band-verb: cow
        """Copy-on-write: privatise one shared block (every band of
        every layer: the payload and, on a quantized pool, its scale
        rows) before the suffix writes into it."""
        for kv in self._cache:
            for buf in kv.values():
                raw = raw_bytes(buf)
                raw[dst] = raw[src]

    # ------------------------------------------------------------------
    # device-resident side-bands
    # ------------------------------------------------------------------
    def _band(self, name):
        if name in self._dirty:
            # a blocking copy on purpose: the scheduler rewrites these
            # numpy buffers in place, and a non_blocking upload from
            # pageable memory could read a later value
            self._dev[name] = torch.tensor(getattr(self, "_" + name),
                                           device=self.device)
            self._dirty.discard(name)
            self.metrics.band_uploads += 1
        return self._dev[name]

    def _mark_dirty(self, *names):
        self._dirty.update(names or _BANDS)

    def _adapter_args(self, aidx) -> dict:
        """The paged primitives' adapter kwargs when the adapter pool is
        on (the stacked pool tensors and `aidx`: the [S] device band, or
        the chunk's one slot as an int); empty otherwise."""
        if self._adapter_pool is None:
            return {}
        return {"adapters": self._adapter_pool.device_arrays(),
                "adapter_idx": aidx}

    # ------------------------------------------------------------------
    # integrity
    # ------------------------------------------------------------------
    def _trip(self, kind: str, detail: str):
        raise IntegrityError(
            "integrity trip%s: %s" % (
                "" if self.replica_id is None
                else " (replica %s)" % self.replica_id, detail),
            kind=kind, replica=self.replica_id)

    def _check_integrity(self, trap, scale, where: str, slots=None):
        """Judge one step's trap flag(s) and magnitude scalar BEFORE its
        tokens are emitted: a tripped slot becomes an integrity event
        instead of a token."""
        trap = np.atleast_1d(np.asarray(trap))
        verdict = self._sentinel.observe(bool(trap.any()), float(scale))
        if verdict == "ok":
            return
        if verdict == "trap":
            bad = (slots if slots is not None
                   else [int(s) for s in np.nonzero(trap)[0]])
            rids = [self._slot_req[s].rid for s in bad
                    if self._slot_req[s] is not None]
            self._trip("trap", "non-finite logits in %s step (slots %s, "
                       "rids %s)" % (where, bad, rids))
        self._trip("spike",
                   "logit magnitude spike in %s step (max-|logit| %.3g vs "
                   "EWMA %.3g x factor %g)"
                   % (where, float(scale),
                      self._sentinel.detector.ewma or 0.0,
                      self._sentinel.detector.spike_factor))

    def _fp_of(self, bid: int) -> float:
        """Recompute one physical block's fingerprint on the device (a
        sync: the value is read back)."""
        return float(tlm.paged_block_fingerprint(self._cache, int(bid)))

    def _decref_block(self, bid) -> bool:
        """Drop one pool reference; a block actually FREED also drops
        its committed fingerprint (a recycled id must never be judged
        against its previous tenant's checksum). Every engine-side
        release goes through here (retirement, trie eviction)."""
        freed = self._alloc.decref(bid)
        if freed and self._fp is not None:
            self._fp.drop(int(bid))
        return freed

    def _flip_resident_block(self):
        """Consume a flip@ fault: corrupt the lowest in-use physical
        block's K payload in place with finite garbage (re-armed while
        nothing is resident)."""
        bid = next((b for b in range(self.num_kv_blocks)
                    if self._alloc.refcount(b) > 0), None)
        if bid is None:
            self._injector.rearm_flip()
            return
        buf = self._cache[0]["k"]
        buf[bid] = (buf[bid].float() * -1.0 + 1.7).to(buf.dtype)

    # ------------------------------------------------------------------
    # durable KV tier
    # ------------------------------------------------------------------
    def _serialize_block(self, bid: int):  # band-verb: serialize
        """Flatten one physical block across every layer and band into
        (payload bytes, meta rows): meta rows are ("li.band", dtype,
        shape per block) in the sorted-band order
        `paged_block_fingerprint` folds, so a record is self-describing
        (codes and scale rows travel together) and its fingerprint is
        recomputable from the payload alone. One device-to-host copy."""
        parts, meta = [], []
        b = int(bid)
        for li, kv in enumerate(self._cache):
            for band in sorted(kv):
                row = kv[band][b]
                meta.append(("%d.%s" % (li, band), _dtype_name(row),
                             tuple(int(x) for x in row.shape)))
                parts.append(_row_bytes(row))
        return torch.cat(parts).cpu().numpy().tobytes(), meta

    def _upload_block_record(self, rec, bid: int) -> bool:  # band-verb: import
        """Write one store record's payload into physical block `bid` in
        place. Every meta row is validated against this engine's cache
        geometry before anything is written: False (and an untouched
        cache) on any layer, band, dtype, shape or length mismatch."""
        payload = rec["payload"]
        off = 0
        planned = []
        for name, dtype, shape in rec["meta"]:
            li_s, _, band = str(name).partition(".")
            try:
                li = int(li_s)
            except ValueError:
                return False
            if li < 0 or li >= len(self._cache) \
                    or band not in self._cache[li]:
                return False
            buf = self._cache[li][band]
            shape = tuple(int(x) for x in shape)
            if shape != tuple(buf.shape[1:]) or _dtype_name(buf) != dtype:
                return False
            n = int(np.prod(shape, dtype=np.int64)) * buf.element_size()
            chunk = payload[off:off + n]
            if len(chunk) != n:
                return False
            off += n
            planned.append((buf, np.frombuffer(chunk, np.uint8)))
        if off != len(payload):
            return False
        b = int(bid)
        for buf, raw in planned:
            _row_bytes(buf[b]).copy_(torch.from_numpy(raw.copy()))
        return True

    def _record_fp_ok(self, rec, fp_d) -> bool:
        """The handoff/warm transfer checksum: the fingerprint recomputed
        on this device after upload vs the record's committed one (the
        aliased re-open's tolerance)."""
        exp = float(rec["fp"])
        return abs(float(fp_d) - exp) <= _FP_RTOL * max(1.0, abs(exp))

    def warm_from_store(self) -> int:  # band-verb: import
        """Restore the durable store's chains into this engine's prefix
        trie (a restart's warm start): parents before children, each
        block crc- and fingerprint-verified on upload and grafted under
        the trie, which takes the fresh block's one pool reference.
        Corrupt entries are skipped and quarantined with their whole
        subtree (a child's context is its ancestors' payloads). Stops at
        the trie's token budget or when the pool runs out. Returns the
        blocks restored."""
        store = self._kv_store
        pc = self.prefix_cache
        if store is None or pc is None:
            return 0
        Bt = self.kv_block_tokens
        n_warm = 0
        chain: Dict[int, list] = {}  # key -> tokens through this block
        skipped = set()
        for rec in store.iter_chains():
            key = rec["key"]
            par = rec["parent"]
            if par in skipped:
                skipped.add(key)  # corrupt ancestor: subtree is dead
                continue
            if par != 0 and par not in chain:
                continue  # unrooted (hole upstream): nothing to graft
            toks = (chain[par] if par else []) \
                + [int(t) for t in rec["tokens"]]
            depth = len(toks) // Bt
            m = pc.match(np.asarray(toks, np.int32), record=False)
            have = m.length
            m.release()
            if have >= depth * Bt:
                chain[key] = toks  # already resident (or just warmed)
                continue
            if pc.size_tokens + Bt > pc.token_budget:
                break  # budget: deeper warms would evict earlier ones
            if len(rec["payload"]) != rec["nbytes"] \
                    or payload_crc(rec["payload"]) != rec["crc"]:
                store.quarantine(key)
                self.metrics.store_quarantined += 1
                skipped.add(key)
                continue
            bid = self._alloc.try_alloc()
            if bid is None:
                break  # pool pressure: serve traffic over warmth
            ok = self._upload_block_record(rec, bid)
            fp_d = self._fp_of(bid) if ok else None
            if not ok or not self._record_fp_ok(rec, fp_d):
                self._decref_block(bid)
                store.quarantine(key)
                self.metrics.store_quarantined += 1
                skipped.add(key)
                continue
            if self._fp is not None:
                self._fp.commit(bid, fp_d)
            # ancestors are resident (the chain gate above), so only
            # this deepest block is novel to the publish
            pc.publish(np.asarray(toks, np.int32), depth,
                       lambda _d, b=bid: b)
            n_warm += 1
            self.metrics.store_warm_blocks += 1
            chain[key] = toks
        return n_warm

    # ------------------------------------------------------------------
    # block bookkeeping
    # ------------------------------------------------------------------
    def _blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.kv_block_tokens)

    def _ensure_blocks(self, s: int, lo: int, hi: int):
        """Materialise (from this slot's reservation) every block
        covering positions [lo, hi) the table has not allocated yet."""
        if hi <= lo:
            return
        Bt = self.kv_block_tokens
        for b in range(lo // Bt, (hi - 1) // Bt + 1):
            if self._tables[s, b] < 0:
                self._tables[s, b] = self._alloc.alloc_reserved()
                self._reserved_tail[s] -= 1
                self._n_alloc[s] += 1
                self._mark_dirty("tables")

    def _reclaim_for(self, need_new: int):
        """Evict idle trie chains until `need_new` blocks are available —
        but only when eviction can bridge the gap (a block-starved
        request retries every step and must not drain the trie)."""
        pc = self.prefix_cache
        if pc is None or self._alloc.available >= need_new:
            return
        gain = sum(1 for bid in pc.idle_payloads()
                   if self._alloc.refcount(int(bid)) == 1)
        if self._alloc.available + gain < need_new:
            return
        while self._alloc.available < need_new:
            if pc.reclaim(need_new - self._alloc.available) == 0:
                break

    def _free_slot_blocks(self, s: int):
        """Retirement: drop this slot's reference on every allocated
        block and release the reserved-but-unreached tail."""
        freed = 0
        for b in range(self.blocks_per_slot):
            bid = int(self._tables[s, b])
            if bid >= 0 and self._decref_block(bid):
                freed += 1
        tail = int(self._reserved_tail[s])
        if tail:
            self._alloc.release_reservation(tail)
        self.metrics.kv_blocks_freed_at_retire += freed
        self.metrics.kv_tail_blocks_freed += tail
        self._tables[s, :] = -1
        self._n_alloc[s] = 0
        self._reserved_tail[s] = 0
        self._limits[s] = 0
        self._mark_dirty("tables", "limits")

    # ------------------------------------------------------------------
    # scheduler
    # ------------------------------------------------------------------
    def submit(self, prompt, max_new_tokens, temperature=0.0, eos_id=None,
               seed=0, publish_len=None, deadline_at=None,
               resume_tokens=None, adapter=None,
               handoff=None) -> ServingHandle:
        """Enqueue one request (FCFS) and return its handle. Requests
        that can never fit (past the positional table, or needing more
        blocks than the whole pool) raise; a merely saturated pool
        queues. `publish_len` bounds what the prefix pool may publish;
        `deadline_at` is an absolute time.monotonic() budget;
        `resume_tokens` are tokens an earlier incarnation emitted;
        `adapter` names a registered adapter (resolved now: an unknown
        one, or any adapter on an engine without a pool, raises);
        `handoff` is the finished prefix's durable-KV records, imported
        at admission after fingerprint verification (re-prefill is the
        counted fallback, never a wrong token)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T0 = prompt.shape[0]
        if T0 < 1:
            raise ValueError("empty prompt")
        E = 0 if resume_tokens is None else len(resume_tokens)
        if int(max_new_tokens) - E < 1:
            raise ValueError(
                "max_new_tokens must leave >= 1 token past the resumed "
                "prefix (%d - %d resumed < 1)" % (int(max_new_tokens), E))
        if T0 + int(max_new_tokens) > self.max_len:
            raise ValueError(
                "request needs T0+max_new <= max_len (%d + %d > %d)"
                % (T0, int(max_new_tokens), self.max_len))
        if self._blocks_for(T0 + int(max_new_tokens)) > self.num_kv_blocks:
            raise ValueError(
                "request worst case (%d blocks) exceeds the whole KV pool "
                "(%d blocks of %d tokens)"
                % (self._blocks_for(T0 + int(max_new_tokens)),
                   self.num_kv_blocks, self.kv_block_tokens))
        if publish_len is not None and publish_len < 0:
            raise ValueError("publish_len must be >= 0 or None")
        if adapter is not None:
            # resolve or refuse NOW, never at admission in the scheduler
            if self._adapter_pool is None:
                raise ValueError(
                    "request names adapter %r but the engine has no "
                    "adapter pool (pass adapter_registry=)" % (adapter,))
            if not self._adapter_pool.registry.has(adapter):
                raise ValueError("unknown adapter %r (registered: %r)"
                                 % (adapter,
                                    self._adapter_pool.registry.names()))
        h = ServingHandle(self, self._next_rid, prompt, max_new_tokens,
                          temperature, eos_id, seed, publish_len,
                          deadline_at=deadline_at,
                          resume_tokens=resume_tokens, adapter=adapter,
                          handoff=handoff)
        self._next_rid += 1
        if deadline_at is not None:
            self._deadlines = True
        if E:
            self.metrics.resumed_requests += 1
            self.metrics.resume_tokens_reused += E
        self._queue.append(h)
        return h

    def _free_slot(self) -> Optional[int]:
        for s in range(self.max_slots):
            if self._slot_req[s] is None:
                return s
        return None

    def _bucket(self, T0: int) -> int:
        return min(bucket_pow2(T0, floor=self.min_bucket), self.max_len)

    def _retire(self, s: int, reason: str):  # band-verb: retire
        h = self._slot_req[s]
        h.done = True
        h.finish_reason = reason
        self._slot_req[s] = None
        self._alive[s] = False
        self._spec_ctx.pop(s, None)
        if self._adapter_pool is not None:
            # drop the request's pin (residency keeps the adapter warm)
            # and point the band back at the zero adapter
            self._adapter_pool.release(int(self._aidx[s]))
            self._aidx[s] = 0
            self._mark_dirty("aidx")
        self._free_slot_blocks(s)
        self.metrics.kv_blocks_in_use = self._alloc.blocks_in_use
        self._mark_dirty("alive")

    def _emit(self, s: int, token: int) -> bool:
        """Append one generated token to slot s's request; retire on EOS
        or budget (EOS on the budget-exhausting step reports 'eos').
        Returns True if the slot was retired."""
        h = self._slot_req[s]
        if self._injector is not None \
                and getattr(self._injector, "garbled", False):
            # garble@ drill: wrong-but-finite output, sticky
            token = (int(token) + 1) % int(self._cfg.vocab)
        h.tokens.append(int(token))
        st = self._spec_ctx.get(s)
        if st is not None:  # keep the drafting index current in O(1)
            ctx = st["ctx"]
            ctx.append(int(token))
            pair = (ctx[-2], ctx[-1])
            st["from"] = st["map"].get(pair)
            st["map"][pair] = len(ctx)
        self._counts[s] += 1
        self.metrics.tokens_out += 1
        if h.eos_id is not None and int(token) == int(h.eos_id):
            self._retire(s, "eos")
            return True
        if len(h.tokens) >= h.max_new_tokens:
            self._retire(s, "budget")
            return True
        return False

    def _admit(self, h: ServingHandle, s: int) -> bool:  # band-verb: alias
        """Try to assign free slot s: alias the longest cached prefix
        chain's physical blocks into the slot's table (ref-counted,
        zero-copy; fingerprint-verified when fingerprints are on),
        copy-on-write any aliased block the suffix must write into,
        reserve the worst-case remainder, pin the request's adapter and
        import its handoff package. Returns False — request stays
        queued, engine state untouched — when the pool (or the adapter
        pool) cannot take it yet."""
        T0 = h.full_prompt.shape[0]
        Bt = self.kv_block_tokens
        need_total = self._blocks_for(T0 + h.max_new_tokens)
        aslot = 0
        pool = self._adapter_pool
        # an adapted model writes adapter-specific K/V: adapter requests
        # skip the token-keyed trie both ways (see _publish)
        pc = self.prefix_cache if h.adapter is None else None
        # a pure PROBE: retries of a block-starved request must not
        # inflate hit/miss stats or restamp LRU order
        m = pc.match(h.full_prompt, record=False) if pc is not None else None
        if m is not None and m.length == 0:
            m.release()
            m = None
        cursor = n_alias = n_cow = 0
        need_new = need_total
        if m is not None:
            matched = m.length
            # the last prompt token must be COMPUTED (its logits seed the
            # first generated token), so the cursor stops at T0-1 even
            # when the whole prompt is cached…
            cursor = min(matched, T0 - 1)
            n_alias = matched // Bt
            # …and an aliased block overlapping [cursor, T0) is
            # copy-on-write privatised, never written through
            n_cow = n_alias - min(n_alias, cursor // Bt)
            need_new = need_total - (n_alias - n_cow)
            self._reclaim_for(need_new)
            if self._alloc.available < need_new:
                # the held match pins the chain reclaim would evict:
                # fall through to a cold-miss admission
                m.release()
                m = None
                cursor = n_alias = n_cow = 0
                need_new = need_total
        if m is None:
            self._reclaim_for(need_new)
            if not self._alloc.reserve(need_new):
                return False  # saturated: stay queued (backpressure)
            if pool is not None:
                # pinned AFTER the block reservation, so a block-starved
                # retry never touches adapter stats or LRU; a pool whose
                # every slot is pinned leaves the request queued
                aslot = pool.acquire(h.adapter)
                if aslot is None:
                    self._alloc.release_reservation(need_new)
                    return False
            if pc is not None:
                pc.record_miss()
        else:
            try:
                if not self._alloc.reserve(need_new):
                    return False  # unreachable single-threaded; defensive
                if pool is not None:
                    aslot = pool.acquire(None)  # trie hits carry none
                if self._fp is not None and n_alias:
                    # the aliased re-open audit point: another request is
                    # about to attend through these blocks. All
                    # reductions are queued before the one readback
                    fps = torch.stack([
                        tlm.paged_block_fingerprint(
                            self._cache, int(m.payloads[d]))
                        for d in range(n_alias)]).cpu().numpy()
                    for d in range(n_alias):
                        bid = int(m.payloads[d])
                        if not self._fp.check(bid, float(fps[d])):
                            self._trip(
                                "fingerprint",
                                "KV block %d fingerprint mismatch on "
                                "aliased re-open (committed %r)"
                                % (bid, self._fp.expected(bid)))
                pc.record_hit(m)
                keep = n_alias - n_cow
                for d in range(keep):
                    bid = int(m.payloads[d])
                    self._alloc.incref(bid)
                    self._tables[s, d] = bid
                for d in range(keep, n_alias):
                    nb = self._alloc.alloc_reserved()
                    self._cow(nb, int(m.payloads[d]))
                    self._tables[s, d] = nb
                    self.metrics.cow_blocks += 1
            finally:
                m.release()
        n_imp, imp_fail = self._import_handoff(h, s, n_alias)
        if n_imp:
            cursor = min((n_alias + n_imp) * Bt, T0 - 1)
        # the zero-recompute audit: closed-block prompt tokens the source
        # had finished vs where this prefill starts (the final prompt
        # token always computes). A resumed admission without a package
        # charges every closed block it re-prefills.
        package = h.handoff
        expected = 0
        if package:
            expected = min(len(package) * Bt, T0 - 1)
        elif h.resume_len > 0:
            expected = min((T0 // Bt) * Bt, T0 - 1)
        recomputed = max(0, expected - cursor)
        self.metrics.tokens_recomputed_at_migration += recomputed
        if package:
            if recomputed > 0 or imp_fail:
                self.metrics.handoff_fallbacks += 1
                h.handoff_fallback = True
            else:
                self.metrics.handoff_imports += 1
            h.handoff_outcome = {"imported": h.handoff_imported,
                                 "fallback": h.handoff_fallback}
            h.handoff = None  # release the payload bytes
        self._n_alloc[s] = n_alias + n_imp
        self._reserved_tail[s] = need_new - n_cow - n_imp
        if pc is not None:
            self.metrics.prefix_hit_tokens.append(cursor if n_alias else 0)
        h.queue_wait_s = time.monotonic() - h.submit_t
        self.metrics.queue_wait_s.append(h.queue_wait_s)
        self.metrics.kv_blocks_in_use = self._alloc.blocks_in_use
        self._slot_req[s] = h
        self._limits[s] = T0 + h.max_new_tokens
        self._aidx[s] = aslot
        self._mark_dirty("tables", "limits", "aidx")
        # the first-token sampling key: token index resume_len of the
        # request's fold_in schedule, consumed on the final chunk
        self._prefill_state[s] = {
            "handle": h, "cursor": cursor,
            "key": prng.fold_in(prng.PRNGKey(h.seed, self.device),
                                h.resume_len),
        }
        self._prefill_q.append(s)
        return True

    def _import_handoff(self, h: ServingHandle, s: int, n_alias: int):
        """Import slot s's handoff package past its aliased blocks: each
        record is token-, crc- and kv_quant-checked, uploaded into a
        block of the slot's reservation, and its recomputed fingerprint
        held against the record's (the transfer checksum). The import
        stops at the first failure (a child's K/V attends through its
        ancestors); a fingerprint liar is quarantined in the store.
        Returns (blocks imported, whether a record failed)."""
        package = h.handoff
        if not package:
            return 0, False
        Bt = self.kv_block_tokens
        store = self._kv_store
        n_imp, failed = 0, False
        for d in range(n_alias, min(len(package), self.blocks_per_slot)):
            rec = package[d]
            blk = tuple(int(t) for t in h.full_prompt[d * Bt:(d + 1) * Bt])
            if (rec.get("kv_quant", "none") != self.kv_quant
                    or tuple(rec["tokens"]) != blk
                    or len(rec["payload"]) != rec["nbytes"]
                    or payload_crc(rec["payload"]) != rec["crc"]):
                failed = True
                break
            bid = self._alloc.alloc_reserved()
            ok = self._upload_block_record(rec, bid)
            fp_d = self._fp_of(bid) if ok else None
            if not ok or not self._record_fp_ok(rec, fp_d):
                # the freed block does not restore the reservation
                # alloc_reserved consumed: re-reserve it (the block just
                # freed guarantees success)
                self._decref_block(bid)
                self._alloc.reserve(1)
                if store is not None and ok:
                    store.quarantine(rec["key"])
                    self.metrics.store_quarantined += 1
                failed = True
                break
            if self._fp is not None:
                self._fp.commit(bid, fp_d)
            self._tables[s, d] = bid
            n_imp += 1
        if n_imp:
            self.metrics.handoff_blocks_imported += n_imp
            self.metrics.handoff_tokens_imported += n_imp * Bt
            h.handoff_imported = n_imp * Bt
        return n_imp, failed

    def _publish(self, s: int, h: ServingHandle):  # band-verb: serialize
        """Publish the finished prompt's whole blocks (up to the publish
        boundary) into the prefix trie — zero-copy: the trie takes a ref
        on the slot's physical block ids. A block closes here: its
        fingerprint commits, and with a store it spills as a record.
        Adapter requests never publish (their K/V is tenant-specific)."""
        pc = self.prefix_cache
        if pc is None or h.adapter is not None:
            return
        T0 = h.full_prompt.shape[0]
        bound = T0 if h.publish_len is None else min(h.publish_len, T0)
        Bt = pc.block_tokens
        n_blocks = bound // Bt
        if n_blocks < 1:
            return
        store = self._kv_store
        # chain keys of the store records: the trie summary's fold
        keys = (chain_keys(h.full_prompt[:n_blocks * Bt], Bt)
                if store is not None else None)

        def _take(d):
            bid = int(self._tables[s, d])
            self._alloc.incref(bid)
            fp = None
            if self._fp is not None or store is not None:
                fp = self._fp_of(bid)
            if self._fp is not None:
                self._fp.commit(bid, fp)
            if store is not None:
                # write-through spill of novel blocks, the fingerprint
                # riding along as the transfer checksum
                payload, meta = self._serialize_block(bid)
                store.put(make_block_record(
                    keys[d], keys[d - 1] if d else 0,
                    tuple(int(t)
                          for t in h.full_prompt[d * Bt:(d + 1) * Bt]),
                    fp, payload, meta, kv_quant=self.kv_quant))
                self.metrics.store_spilled_blocks += 1
            return bid

        pc.publish(h.full_prompt, n_blocks, _take)

    def _run_chunk(self, s: int) -> bool:  # band-verb: resume
        """Advance slot s's prefill by one chunk; on the final chunk,
        publish the prefix, activate the slot and emit the first token.
        Returns True when the prefill completed."""
        st = self._prefill_state[s]
        h = st["handle"]
        T0 = h.full_prompt.shape[0]
        cursor = st["cursor"]
        c = T0 - cursor
        if self.prefill_chunk_tokens is not None:
            c = min(c, self.prefill_chunk_tokens)
        self._ensure_blocks(s, cursor, cursor + c)
        Cb = self._bucket(c)
        padded = np.zeros(Cb, np.int32)
        padded[:c] = h.full_prompt[cursor:cursor + c]
        t0 = time.monotonic()
        logits, _ = tlm.paged_prefill_chunk(
            self._step_params(), self._cache,
            torch.tensor(padded, device=self.device), cursor,
            torch.tensor(self._tables[s], device=self.device), self._cfg,
            true_len=c, kernel=self.paged_kernel, kv_quant=self.kv_quant,
            **self._adapter_args(int(self._aidx[s])))
        st["cursor"] = cursor + c
        self.metrics.prefill_chunks += 1
        self.metrics.prefill_tokens_computed += c
        self.metrics.kv_blocks_in_use = self._alloc.blocks_in_use
        if st["cursor"] < T0:
            # mid-prompt chunk: nothing to read back
            self.metrics.span("prefill_T%d" % Cb, time.monotonic() - t0)
            return False
        if h.temperature > 0:
            first_d = prng.categorical(
                st["key"], logits.float()
                / torch.tensor(h.temperature, dtype=torch.float32))
        else:
            first_d = torch.argmax(logits)
        first = int(first_d)  # syncs: the first token is real
        if self.integrity_traps:
            trap, scale = self._traps(logits)
            self._check_integrity(bool(trap), float(scale),
                                  "prefill chunk", slots=[s])
        now = time.monotonic()
        h.ttft_s = now - h.submit_t
        self.metrics.ttft_s.append(h.ttft_s)
        self.metrics.span("prefill_T%d" % Cb, now - t0)
        self.metrics.observe_device_interval(t0, now)
        self.metrics.prefills += 1
        self._publish(s, h)
        del self._prefill_state[s]

        self._tok[s] = first
        self._pos[s] = T0
        self._alive[s] = True
        self._temps[s] = h.temperature
        # a resumed request continues the original fold_in schedule
        self._counts[s] = h.resume_len
        self._base_keys[s] = (0, int(h.seed) & 0xFFFFFFFF)  # PRNGKey(seed)
        # the decode window judges EOS on the device (-1 = none)
        self._eos[s] = -1 if h.eos_id is None else int(h.eos_id)
        if self.spec_draft_len is not None:
            # seed the drafting index from the context once (O(T0));
            # _emit keeps it current per token from here on
            ctx = [int(t) for t in h.full_prompt]
            bmap = {}
            for i in range(len(ctx) - 1):
                bmap[(ctx[i], ctx[i + 1])] = i + 2
            self._spec_ctx[s] = {"ctx": ctx, "map": bmap, "from": None}
        self._mark_dirty()  # all bands: slot s changed everywhere
        self._emit(s, first)  # may retire immediately
        return True

    def _drop_slot(self, s: int, reason: str):
        """Terminate slot s's request without emitting (deadline or
        cancel): clear any pending prefill cursor, then retire."""
        if s in self._prefill_state:
            del self._prefill_state[s]
            self._prefill_q.remove(s)
        self._retire(s, reason)

    def _expire_sweep(self) -> bool:
        """Enforce per-request deadlines at every queue hop: queued
        requests before admission, prefilling and decoding slots before
        their next step. Expiry is a verdict (finish_reason 'expired')."""
        if not self._deadlines:
            return False
        now = time.monotonic()
        changed = False
        seen = False  # any deadline still pending after this sweep?
        keep: collections.deque = collections.deque()
        while self._queue:
            h = self._queue.popleft()
            if h.deadline_at is not None and now >= h.deadline_at:
                h.done = True
                h.finish_reason = "expired"
                self.metrics.expired += 1
                changed = True
            else:
                seen = seen or h.deadline_at is not None
                keep.append(h)
        self._queue = keep
        for s in range(self.max_slots):
            h = self._slot_req[s]
            if h is not None and h.deadline_at is not None:
                if now >= h.deadline_at:
                    self._drop_slot(s, "expired")
                    self.metrics.expired += 1
                    changed = True
                else:
                    seen = True
        if not seen:
            self._deadlines = False
        return changed

    def cancel(self, rid) -> bool:
        """Terminate one request wherever it is (queued, prefilling or
        decoding); its handle finishes 'cancelled' with its partial
        tokens. False if the rid is unknown or already finished."""
        for h in self._queue:
            if h.rid == rid and not h.done:
                self._queue.remove(h)
                h.done = True
                h.finish_reason = "cancelled"
                self.metrics.cancelled += 1
                return True
        for s in range(self.max_slots):
            h = self._slot_req[s]
            if h is not None and h.rid == rid:
                self._drop_slot(s, "cancelled")
                self.metrics.cancelled += 1
                return True
        return False

    def abort(self, exc: BaseException):
        """Latch the engine as failed and propagate `exc` into every
        pending handle, so their `result()` raises instead of blocking.
        Idempotent; the first failure wins."""
        if self._failed is None:
            if isinstance(exc, EngineFailed):
                self._failed = exc
            else:
                self._failed = EngineFailed(
                    "engine%s failed: %r" % (
                        "" if self.replica_id is None
                        else " (replica %s)" % self.replica_id, exc),
                    replica=self.replica_id)
                self._failed.__cause__ = exc
        for h in list(self._queue) + list(self._slot_req):
            if h is not None and not h.done and h.error is None:
                h.error = self._failed

    def step(self) -> bool:
        """One scheduler iteration: expire what is past its deadline,
        admit queued requests into free slots, advance pending prefills
        (FCFS, at most one chunk per slot and `max_prefills_per_step` in
        total), then ONE batched decode over every live slot. Returns
        False when there was nothing to do. Each call first ticks the
        fault injector; any failure aborts every pending handle and
        latches the engine."""
        if self._failed is not None:
            raise self._failed
        inj = self._injector
        if inj is None:
            inj = self._injector = (
                _fi.default_injector()
                if os.environ.get(_fi.ENV_VAR) else _fi.FaultInjector(""))
        t0 = time.monotonic()
        try:
            if inj.active:
                inj.tick()
                if inj.take_flip():
                    self._flip_resident_block()
            out = self._step_inner()
        except Exception as exc:
            self.abort(exc)
            raise
        # per-token EWMA: the static window size, not the emitted count
        # (a low-occupancy window still runs K iterations)
        self.metrics.observe_step(time.monotonic() - t0,
                                  tokens=self.decode_window)
        return out

    def _step_inner(self) -> bool:
        progressed = self._expire_sweep()
        while self._queue:
            s = self._free_slot()
            if s is None:
                break
            if not self._admit(self._queue[0], s):
                break  # block-starved: the FCFS head waits, so do followers
            self._queue.popleft()
            progressed = True

        cap = self.max_prefills_per_step
        chunks = 0
        for s in list(self._prefill_q):
            if cap is not None and chunks >= cap:
                break
            if self._run_chunk(s):
                self._prefill_q.remove(s)
            chunks += 1
            progressed = True

        if self._use_window:
            # a pending async window may still hold the tokens that
            # retire the last requests: the phase runs with no live slot
            if not self._window_phase():
                return progressed
        elif not self._alive.any():
            return progressed
        elif self.spec_draft_len is not None:
            self._spec_step()
        else:
            self._decode_once()

        frag = 0
        for s in np.nonzero(self._alive)[0]:
            frag += int(self._n_alloc[s]) * self.kv_block_tokens \
                - int(self._pos[s])
        for s in self._prefill_q:
            frag += int(self._n_alloc[s]) * self.kv_block_tokens \
                - int(self._prefill_state[s]["cursor"])
        self.metrics.kv_frag_tokens = frag
        self.metrics.kv_blocks_in_use = self._alloc.blocks_in_use
        return True

    def _decode_once(self):  # band-verb: sync
        """The batched decode: one token per live slot. The step
        advances tok/pos/counts on the device and the engine adopts
        them, so an admission-free step uploads nothing (tables change
        only at a block-boundary append)."""
        live = np.nonzero(self._alive)[0]
        for s in live:
            p = int(self._pos[s])
            self._ensure_blocks(s, p, p + 1)
        sample_rows = live[self._temps[live] > 0]
        t0 = time.monotonic()
        nxt_d, pos_d, counts_d, trap_d, scale_d = self._decode_step(
            sample_rows)
        nxt = nxt_d.cpu().numpy()  # syncs; tokens are real
        if self.integrity_traps:
            # checked before the emit loop: no token from a poisoned
            # step reaches a handle
            self._check_integrity(trap_d.cpu().numpy(), float(scale_d),
                                  "decode")
        self._dev["tok"], self._dev["pos"], self._dev["counts"] = (
            nxt_d, pos_d, counts_d)
        self._dirty.difference_update(("tok", "pos", "counts"))
        t1 = time.monotonic()
        self.metrics.span("decode_step", t1 - t0)
        self.metrics.observe_device_interval(t0, t1)
        self.metrics.decode_steps += 1
        self.metrics.occupancy.append(
            float(self._alive.sum()) / self.max_slots)

        self._pos[live] += 1  # the token just cached sat at pos
        for s in live:
            self._tok[s] = nxt[s]
            self._emit(s, nxt[s])

    # ------------------------------------------------------------------
    # decode windows and async dispatch
    # ------------------------------------------------------------------
    def _can_chain(self) -> bool:
        """Window N+1 may chain off window N's unsynced device outputs
        only while the device-advanced bands still carry device truth:
        a host event since the dispatch dirtied one and breaks the
        chain (sync first, re-upload host truth, then dispatch)."""
        return not (self._dirty & _DEVICE_ADVANCED)

    def _window_phase(self) -> bool:
        """The window engine's decode phase: sync the pending window (if
        any) and keep the async pipeline one window deep, or run one
        dispatch and sync in line (sync mode). False only when there is
        nothing to do: no live slot and no pending window."""
        rec, self._inflight = self._inflight, None
        if rec is None and not self._alive.any():
            return False
        if rec is not None:
            chained = None
            if self.async_dispatch and self._alive.any() \
                    and self._can_chain():
                # enqueue window N+1 off window N's device outputs BEFORE
                # syncing N: the emission below overlaps N+1's device work
                chained = self._dispatch_window(prev=rec)
            self._sync_window(rec)
            self._inflight = chained
            if chained is None and self.async_dispatch \
                    and self._alive.any():
                # chain broken by a host event: host truth is current
                # again after the sync, so refill the pipeline now
                self._inflight = self._dispatch_window()
            return True
        w = self._dispatch_window()
        if self.async_dispatch:
            self._inflight = w  # emission runs one window behind
        else:
            self._sync_window(w)
        return True

    def _dispatch_window(self, prev=None):
        """Enqueue one K-token window. `prev` chains it off that unsynced
        window's output bands (the host mirrors are a window stale then,
        so blocks are ensured over a 2K-position horizon)."""
        K = self.decode_window
        live = np.nonzero(self._alive)[0]
        horizon = 2 * K if prev is not None else K
        for s in live:
            p = int(self._pos[s])
            # only positions < limits - 1 are ever written (the budget
            # rule parks a slot after its write at limits - 2)
            self._ensure_blocks(
                s, p, min(p + horizon, int(self._limits[s]) - 1))
        return self._launch_window(prev, live)

    def _launch_window(self, prev, live):
        """The window's device work once its blocks are in the tables:
        bands from the host (uploaded only if dirty) or, chained, from
        `prev`'s outputs. A steady chained launch uploads and reads back
        nothing."""
        t0 = time.monotonic()
        if prev is None:
            tok_d, pos_d = self._band("tok"), self._band("pos")
            alive_d, counts_d = self._band("alive"), self._band("counts")
        else:
            tok_d, pos_d, alive_d, counts_d = prev["bands"]
        bands, packed = self._window_fn(
            self._band("tables"), tok_d, pos_d, alive_d, self._band("temps"),
            counts_d, self._band("base_keys"), self._band("limits"),
            self._band("eos"), self._band("aidx"))
        self.metrics.decode_steps += 1
        self.metrics.occupancy.append(
            float(self._alive.sum()) / self.max_slots)
        return {"bands": bands, "packed": packed, "t0": t0,
                "slots": [(int(s), self._slot_req[int(s)]) for s in live]}

    def _sync_window(self, rec):  # band-verb: sync
        """Sync one dispatched window (its one readback) and emit its
        tokens in iteration order. Lane discipline: -1 lanes are parking
        padding and are dropped; a slot whose request changed since the
        dispatch (expired, cancelled, refilled) drops its remaining
        lanes. Each iteration's traps are judged BEFORE its tokens emit,
        so a trip in iteration j poisons only tokens >= j; all-parked
        rows are skipped so the spike EWMA never sees masked zeros.
        Then the window's bands become device truth only where the host
        mirrors agree with them; otherwise host truth re-uploads."""
        K, S = self.decode_window, self.max_slots
        flat = rec["packed"].cpu().numpy()  # the sync point
        t1 = time.monotonic()
        self.metrics.span("decode_step", t1 - rec["t0"])
        self.metrics.observe_device_interval(rec["t0"], t1)
        ints = flat[:(2 * K + 4) * S].reshape(2 * K + 4, S)
        toks = ints[:K]
        ntok, npos, nalive, ncounts = ints[K:K + 4]
        traps_w = ints[K + 4:]
        scales_w = flat[(2 * K + 4) * S:].view(np.float32)
        for j in range(K):
            row = toks[j]
            if self.integrity_traps and (row >= 0).any():
                self._check_integrity(traps_w[j] != 0, scales_w[j],
                                      "decode window")
            for s, h in rec["slots"]:
                if self._slot_req[s] is not h or not self._alive[s]:
                    continue  # expired, cancelled or refilled: discard
                t = int(row[s])
                if t < 0:
                    continue  # parked lane
                self._pos[s] += 1  # the token just synced sat at pos
                self._tok[s] = t
                self._emit(s, t)
        if (np.array_equal(self._pos, npos)
                and np.array_equal(self._alive, nalive != 0)
                and np.array_equal(self._counts, ncounts)
                and np.array_equal(self._tok, ntok)):
            tok_d, pos_d, alive_d, counts_d = rec["bands"]
            self._dev["tok"], self._dev["pos"] = tok_d, pos_d
            self._dev["alive"], self._dev["counts"] = alive_d, counts_d
            self._dirty.difference_update(_DEVICE_ADVANCED)
        else:
            self._mark_dirty(*_DEVICE_ADVANCED)

    def _draft_window(self, s: int) -> np.ndarray:
        """Self-drafting by prompt lookup: continue the context's last
        bigram from its most recent earlier occurrence (the request's own
        text as the draft model). Unfilled draft rows are -1, never
        accepted (candidates are vocab ids), so a draft-less window is a
        plain one-token decode."""
        K = self.spec_draft_len
        w = np.full(K, -1, np.int32)
        w[0] = self._tok[s]  # the pending (unwritten) token leads
        st = self._spec_ctx.get(s)
        if st is not None and st["from"] is not None:
            cont = st["ctx"][st["from"]:st["from"] + K - 1]
            w[1:1 + len(cont)] = cont
        return w

    def _spec_step(self):  # band-verb: sync
        """One speculative decode phase: build every live slot's K-token
        window, verify all in one batched step, then emit the model's
        own candidates up to the first draft mismatch plus the bonus
        token, within each request's budget. Acceptance is a host
        decision, so tok/pos/counts re-upload next step."""
        K = self.spec_draft_len
        live = np.nonzero(self._alive)[0]
        window = np.zeros((self.max_slots, K), np.int32)
        for s in live:
            lo = int(self._pos[s])
            self._ensure_blocks(s, lo, min(lo + K, int(self._limits[s])))
            window[s] = self._draft_window(s)
        sample_rows = live[self._temps[live] > 0]
        t0 = time.monotonic()
        cand_d, trap_d, scale_d = self._verify_step(
            torch.tensor(window, device=self.device), sample_rows)
        cand = cand_d.cpu().numpy()  # syncs; candidates are real
        if self.integrity_traps:
            self._check_integrity(trap_d.cpu().numpy(), float(scale_d),
                                  "spec verify")
        t1 = time.monotonic()
        self.metrics.span("spec_verify", t1 - t0)
        self.metrics.observe_device_interval(t0, t1)
        self.metrics.decode_steps += 1
        self.metrics.occupancy.append(
            float(self._alive.sum()) / self.max_slots)
        for s in live:
            h = self._slot_req[s]
            m = 0  # accepted drafts: the window prefix the model agrees with
            while m < K - 1 and window[s, m + 1] == cand[s, m]:
                m += 1
            budget_left = h.max_new_tokens - len(h.tokens)
            n = min(m + 1, budget_left)
            self.metrics.spec_windows += 1
            # only drafts actually proposed (-1 rows are empty lanes) and
            # within the remaining budget count as drafted
            lanes = window[s, 1:max(1, budget_left)]
            self.metrics.spec_drafted += int((lanes >= 0).sum())
            adv = 0
            for j in range(n):
                adv += 1
                self._tok[s] = cand[s, j]
                if self._emit(s, cand[s, j]):
                    break  # EOS/budget: later accepted drafts discarded
            self._pos[s] += adv  # one cache write per emitted token
            self.metrics.spec_accepted += max(0, adv - 1)
        self._mark_dirty("tok", "pos", "counts")

    def run(self) -> Dict[int, np.ndarray]:
        """Drive the engine until the queue drains and every slot
        retires; returns {request_id: full sequence} for every request
        completed during this call."""
        finished: Dict[int, np.ndarray] = {}
        pending = list(self._queue) + [
            h for h in self._slot_req if h is not None]
        while self.step():
            pass
        for h in pending:
            if h.done:
                finished[h.rid] = np.concatenate(
                    [h.full_prompt, np.asarray(h.tokens, np.int32)])
        return finished

    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return len(self._queue)

    @property
    def live_slots(self) -> int:
        return int(self._alive.sum())

    @property
    def prefilling_slots(self) -> int:
        return len(self._prefill_q)

    @property
    def kv_blocks_in_use(self) -> int:
        return self._alloc.blocks_in_use

    @property
    def kv_blocks_free(self) -> int:
        return self._alloc.free_blocks
