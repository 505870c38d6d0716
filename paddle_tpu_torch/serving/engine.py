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
    start of every step.

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

Not ported yet (each raises NotImplementedError naming its ROADMAP
item): decode windows and async dispatch, LoRA adapters, KV
fingerprints and the durable KV store.
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
from .integrity import IntegrityError, ServingSentinel
from .kv_blocks import KVBlockAllocator
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .quantization import dequantize_params, quantize_params

__all__ = ["ServingEngine", "ServingHandle", "EngineFailed",
           "IntegrityError"]

# per-slot side-bands the decode step reads; kept device-resident and
# re-uploaded only when a scheduler event dirties one
_BANDS = ("tok", "pos", "alive", "temps", "counts", "base_keys", "tables",
          "limits")

_ROADMAP_WINDOW = "the engine's decode-window and async path"
_ROADMAP_STORE = "integrity fingerprints and the KV store"


def bucket_pow2(m: int, floor: int = 8) -> int:
    """Smallest power of two >= m (at least `floor`): the prefill chunk
    pad length, so chunk shapes stay O(log max_len) (a copy of
    paddle_tpu/fluid/core/kernels_sequence.bucket_pow2)."""
    b = floor
    while b < m:
        b *= 2
    return b


def _refuse(knob: str, item: str):
    raise NotImplementedError("ServingEngine(%s) is not ported yet — "
                              "ROADMAP: %s" % (knob, item))


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
    `result()` returns the full sequence."""

    def __init__(self, engine, rid, prompt, max_new_tokens, temperature,
                 eos_id, seed, publish_len, deadline_at=None,
                 resume_tokens=None):
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
    (None | "int8") as in the reference. `params` must already live on
    `device` (CUDA by default)."""

    def __init__(self, params, cfg, max_slots=8, max_len=None,
                 min_bucket=8, max_prefills_per_step=None,
                 prefill_chunk_tokens=None, prefix_cache_tokens=None,
                 kv_block_tokens=None, kv_pool_blocks=None,
                 spec_draft_len=None, replica_id=None,
                 fault_injector=None, adapter_registry=None,
                 paged_kernel="fused", kv_quant="none", weight_quant=None,
                 integrity_traps=True, kv_fingerprints=False,
                 integrity_spike_factor=None, kv_store=None,
                 decode_window=None, async_dispatch=False, device=None):
        if spec_draft_len is not None and int(spec_draft_len) < 0:
            raise ValueError("spec_draft_len must be >= 0 or None")
        # K < 2 means no drafts to verify: the plain decode step
        self.spec_draft_len = (
            int(spec_draft_len) if spec_draft_len and int(spec_draft_len) >= 2
            else None)
        if self.spec_draft_len is not None and (
                decode_window not in (None, 1) or async_dispatch):
            raise ValueError(
                "spec_draft_len composes with neither decode_window>1 "
                "nor async_dispatch: speculative acceptance is a host "
                "decision after every verify step — run spec with "
                "decode_window=1 and async_dispatch=False")
        if decode_window not in (None, 1):
            _refuse("decode_window>1", _ROADMAP_WINDOW)
        if async_dispatch:
            _refuse("async_dispatch", _ROADMAP_WINDOW)
        if adapter_registry is not None:
            _refuse("adapter_registry", "adapters")
        tlm._kv_quant_check(kv_quant)
        self.kv_quant = kv_quant
        if weight_quant not in (None, "int8"):
            raise ValueError("weight_quant must be None or 'int8' (got %r)"
                             % (weight_quant,))
        self.weight_quant = weight_quant
        if kv_store is not None:
            _refuse("kv_store", _ROADMAP_STORE)
        if kv_fingerprints:
            _refuse("kv_fingerprints", _ROADMAP_STORE)
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
        self.metrics = ServingMetrics(S)
        self.metrics.paged_kernel = paged_kernel
        self.metrics.kv_quant = kv_quant
        self.metrics.weight_quant = weight_quant
        self.metrics.spec = self.spec_draft_len is not None
        self.metrics.kv_blocks_total = NB
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        self.kv_block_bytes = tlm.kv_block_bytes(
            cfg.layers, cfg.heads, cfg.dim // cfg.heads, Bt, kv_quant,
            act_itemsize=itemsize)
        self._alloc = KVBlockAllocator(
            NB, Bt, block_bytes=self.kv_block_bytes)  # guarded-by: scheduler
        self.prefix_cache: Optional[PrefixCache] = None
        if prefix_cache_tokens:
            self.prefix_cache = PrefixCache(
                int(prefix_cache_tokens), block_tokens=Bt,
                on_evict=self._alloc.decref)
            self.metrics.prefix_cache = self.prefix_cache
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
        # it park their writes
        self._limits = np.zeros(S, np.int32)  # guarded-by: scheduler
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
        self.replica_id = replica_id
        self._failed: Optional[EngineFailed] = None  # guarded-by: scheduler
        # fault-injection tick source for step(): an explicit injector,
        # or (resolved on the first step) the process-wide default when
        # PADDLE_FAULT is set, else an inert one
        self._injector = fault_injector       # guarded-by: scheduler

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
            self._cfg, kernel=self.paged_kernel, kv_quant=self.kv_quant)
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
            kv_quant=self.kv_quant)
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
            self._dev[name] = torch.tensor(getattr(self, "_" + name),
                                           device=self.device)
            self._dirty.discard(name)
            self.metrics.band_uploads += 1
        return self._dev[name]

    def _mark_dirty(self, *names):
        self._dirty.update(names or _BANDS)

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
            if bid >= 0 and self._alloc.decref(bid):
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
        `resume_tokens` are tokens an earlier incarnation emitted."""
        if adapter is not None:
            _refuse("submit(adapter=)", "adapters")
        if handoff is not None:
            _refuse("submit(handoff=)", _ROADMAP_STORE)
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
        h = ServingHandle(self, self._next_rid, prompt, max_new_tokens,
                          temperature, eos_id, seed, publish_len,
                          deadline_at=deadline_at,
                          resume_tokens=resume_tokens)
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
        zero-copy), copy-on-write any aliased block the suffix must
        write into, and reserve the worst-case remainder. Returns False
        — request stays queued, engine state untouched — when the pool
        cannot cover the reservation even after reclaiming idle trie
        blocks."""
        T0 = h.full_prompt.shape[0]
        Bt = self.kv_block_tokens
        need_total = self._blocks_for(T0 + h.max_new_tokens)
        pc = self.prefix_cache
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
            if pc is not None:
                pc.record_miss()
        else:
            try:
                if not self._alloc.reserve(need_new):
                    return False  # unreachable single-threaded; defensive
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
        self._n_alloc[s] = n_alias
        self._reserved_tail[s] = need_new - n_cow
        if pc is not None:
            self.metrics.prefix_hit_tokens.append(cursor if n_alias else 0)
        h.queue_wait_s = time.monotonic() - h.submit_t
        self.metrics.queue_wait_s.append(h.queue_wait_s)
        self.metrics.kv_blocks_in_use = self._alloc.blocks_in_use
        self._slot_req[s] = h
        self._limits[s] = T0 + h.max_new_tokens
        self._mark_dirty("tables", "limits")
        # the first-token sampling key: token index resume_len of the
        # request's fold_in schedule, consumed on the final chunk
        self._prefill_state[s] = {
            "handle": h, "cursor": cursor,
            "key": prng.fold_in(prng.PRNGKey(h.seed, self.device),
                                h.resume_len),
        }
        self._prefill_q.append(s)
        return True

    def _publish(self, s: int, h: ServingHandle):
        """Publish the finished prompt's whole blocks (up to the publish
        boundary) into the prefix trie — zero-copy: the trie takes a ref
        on the slot's physical block ids."""
        pc = self.prefix_cache
        if pc is None:
            return
        T0 = h.full_prompt.shape[0]
        bound = T0 if h.publish_len is None else min(h.publish_len, T0)
        n_blocks = bound // pc.block_tokens
        if n_blocks < 1:
            return

        def _take(d):
            bid = int(self._tables[s, d])
            self._alloc.incref(bid)
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
            true_len=c, kernel=self.paged_kernel, kv_quant=self.kv_quant)
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
        self.metrics.observe_step(time.monotonic() - t0)
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

        if not self._alive.any():
            return progressed
        if self.spec_draft_len is not None:
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
        self.metrics.decode_steps += 1
        self.metrics.occupancy.append(
            float(self._alive.sum()) / self.max_slots)

        self._pos[live] += 1  # the token just cached sat at pos
        for s in live:
            self._tok[s] = nxt[s]
            self._emit(s, nxt[s])

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
