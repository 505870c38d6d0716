"""Fault-tolerant serving fleet: N supervised `ServingEngine` replicas
behind one front door (counterpart of paddle_tpu/serving/fleet.py).

The port's fleet is the JAX package's host logic unchanged — the same
journal records, routing, failover, rollout, canary and scaling
decisions — over the port's engines. Its journals, its `save_weights`
checkpoints and its wire frames are interchangeable with the JAX
package's. Engines run on the card unless `engine_kw` names the CPU
(`device="cpu"`); with no card the fleet raises in its constructor.
Every replica thread launches the Hopper paged-attention kernels on the
same card and the same (current) CUDA stream; each engine is confined
to its replica's thread.

The reference's cloud layer exists so that *training* survives any
single process dying: the Go master leases tasks with timeouts and
fencing, etcd TTL keys detect dead trainers, and the cluster controller
respawns them (go/master/service.go, go/pserver/etcd_client.go).
`distributed/` rebuilds those primitives for trainers — coordinator
heartbeats, incarnation-fenced membership, lease generations, supervisor
restart/backoff. This module points the same control plane at
*inference*: one `ServingFleet` owns N engine replicas (in-process
threads here; a subprocess mode through `distributed/supervisor.py`
below for kill drills), and a crash mid-decode loses nothing.

Guarantees (the drills' falsifiability bar, recast for serving):

  * No request lost — every `submit()` lands in a durable REQUEST
    JOURNAL before it is routed; when a replica dies (crash, hang past
    the heartbeat deadline, or drill kill), its queued + in-flight
    requests are recovered FROM THE JOURNAL and resubmitted to
    survivors. Outputs are token-identical to sequential `generate()`
    no matter which replica (or how many replicas, in sequence) ran
    the request: the engine's per-request sampling keys depend only on
    (seed, token index), never on slot or replica assignment.
  * No request answered twice — completions are deduplicated by
    request id, and a result reported by a replica that has been
    declared dead is REFUSED (incarnation fencing: the registered
    replica object + its incarnation are the liveness lease, exactly
    the zombie-holder rule the coordinator's task leases enforce). A
    stalled replica that wakes after failover cannot overwrite the
    survivor's answer.
  * Bounded admission — at most `max_pending` requests may be open
    (queued + in-flight) fleet-wide; past that `submit()` raises
    `FleetSaturated` instead of growing an unbounded queue. Explicit
    load-shed is the backpressure contract: the CALLER decides what to
    drop, the fleet never hides an hour of queue wait.
  * Prefix-affinity routing — each replica's engine publishes a
    host-side SUMMARY of its prefix pool (chained-crc block keys,
    `prefix_cache.chain_keys`); routing sends a prompt to the replica
    whose pool holds its longest cached prefix (ties: least loaded),
    so shared-header families keep hitting the replica whose blocks
    are hot and the prefill deletion becomes a fleet-wide number
    (RadixAttention-style reuse, now across replicas).
  * Drain/refill — `drain(i)` stops admitting to a replica, finishes
    its in-flight work (publishing prefixes back to its pool as every
    completed prefill does), then parks it; `refill(i)` brings a
    DRAINED replica back with its engine — and prefix pool — warm, or
    replaces a DEAD one with a fresh incarnation. Planned restarts
    lose neither requests nor the hot prefix working set.
  * SLO classes — `replica_slo` maps each replica to a class
    ("interactive"/"batch"), and `slo_classes` maps the class onto the
    engine's `max_prefills_per_step` (interactive = 1: flattest decode
    latency; batch = None: maximum prefill throughput). `submit(slo=)`
    routes within the class, falling back to any live replica before
    failing — SLO is a preference, survival is a guarantee.
  * Per-request deadlines — `submit(deadline_s=)` journals
    the budget with the spec and enforces it at EVERY queue hop:
    dead-on-arrival requests raise `DeadlineExceeded` before the
    saturation shed, the routing hop expires inbox requests whose
    budget died waiting, and the engine expires queued / prefilling /
    decoding requests before spending another step on them. Expiry is
    a terminal journal verdict (`expired`) — no request is ever late
    without one, and the scheduler never burns decode steps on a
    request that cannot be answered in budget.
  * Gray-failure demotion + hedged failover with token-level resume
    — fail-stop detection (heartbeats) cannot see a replica
    that is alive but too slow (Huang et al., "Gray Failure"; Dean &
    Barroso, "The Tail at Scale"). With `slow_replica_factor` set, the
    monitor scores every busy replica's step-latency EWMA against the
    live-fleet median and watches a decode-progress watermark (tokens
    per wall-second); a replica slow past the factor for
    `slow_min_duration_s` (hysteresis: one GC pause decays out of the
    EWMA and resets the clock) is DEMOTED — not killed: its open
    requests are hedged to survivors, it cancels the clawed-back work,
    stays warm, and is probed every `probe_interval_s` until healthy,
    then restored under the SAME incarnation with its prefix pool hot.
    Hedged (and failed-over) requests resume at the TOKEN level: every
    emitted token is journaled incrementally (batched, flush-deferred
    records), the survivor is submitted `prompt + tokens_already_
    emitted` with the original sampling-key schedule continued at the
    resume index, and the prefix pool aliases whatever prefix it
    holds — decode steps are never re-spent, outputs stay
    token-identical to an uninterrupted `generate()`. The journal's
    latest ASSIGNMENT is the lease: a demoted replica racing its
    hedged survivor has its completions and progress refused, exactly
    like a zombie lease-holder.
  * Prefill/decode disaggregation — with `replica_tier`
    set, admissions route to PREFILL-tier replicas (engine tuned for
    prefill throughput, `max_prefills_per_step=None`) and MIGRATE at
    first token to a DECODE-tier replica: the fleet journals the
    prefill replica's progress, cancels its claim (same handshake —
    it never spends another step), and resubmits with
    `resume_tokens=` — the token-level resume used ON PURPOSE
    instead of on failure. The decode replica prefill-aliases the
    finished prefill (block aliasing against its own pool, fed by
    prefix-affinity routing), ZERO journaled tokens are re-decoded,
    and outputs stay token-identical to a single-replica run (the
    engine's sampling keys depend only on (seed, token index)).
  * Queue-driven autoscaling — with `min_replicas <
    max_replicas`, the monitor's scale sweep spawns replicas when open
    requests outrun live capacity (`scale_up_open_per_replica`) or
    deadline headroom shrinks below `scale_up_headroom_s`, and retires
    them after `scale_down_idle_s` of sustained low load. Scale-up
    goes through the warm `refill()` machinery (a DRAINED replica
    resumes warm; otherwise a fresh incarnation spawns, gated by the
    supervisor's exponential restart backoff); scale-down is a
    graceful `drain()` → retire: queued requests re-route immediately,
    in-flight work is hedged to survivors FROM THE JOURNAL with
    token-level resume, and the replica's stats fold into the
    cumulative base so fleet totals stay monotonic. One cool-down gate
    (`scale_cooldown_s`) covers both directions — a burst cannot flap
    the fleet.
  * Live weight rollout — `roll_weights(ckpt_step)`
    consumes a training checkpoint (default: the sentinel's promoted
    known-good step) and performs a rolling drain → swap → refill
    across the fleet. The candidate is CRC-verified with
    `resume_or_init`'s per-step walk machinery BEFORE any replica
    touches it — a failed verify aborts the rollout with the fleet
    untouched, every replica still serving the old version. Every
    response records the `weights_version` that produced it (assign
    and done journal records carry the version side-band; the journal
    DFA's J009 rejects a done whose version differs from its latest
    assignment's). In-flight requests either FINISH on the old
    version (policy "finish", the default: the drain waits) or
    migrate-resume onto the new one (policy "migrate": hedged from
    the journal like a demotion) — pinned by the `rollout_policy`
    knob, so a request's verdict version always matches its final
    assignment.
  * Serving integrity — replicas that are alive, fast, and
    WRONG: the engines' in-step numeric traps and KV block
    fingerprints raise `IntegrityError` into the crash path, and
    `canary_interval_s` adds known-answer canary requests on LIVE
    replicas judged against a per-weights_version golden trace. Any
    trip QUARANTINES the replica (killed under a fresh incarnation
    through the supervisor backoff) and journals an `integrity`
    record tainting its progress since the last clean canary: the
    mirror truncates to the verified prefix, resubmission resumes
    from the last verified token index, and the taint window
    re-decodes on a healthy survivor — the one sanctioned exception
    to the zero-re-decode rule, audited by the journal DFA's J010.
    A done landing from inside a taint window is refused by the
    fence (the tripped incarnation is dead; `zombie_refused`).

Threading: all shared scheduler state lives on `ServingFleet` and is
guarded by ONE condition's lock (`_cond`); replica threads and the
monitor thread touch it only through fleet methods that take it.
Engines (and their prefix tries) are confined to their replica's
thread — the router sees pools only through the immutable summary sets
handed over under the lock.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

import torch

from .. import resolve_device
from ..distributed.supervisor import restart_backoff_s as _backoff
from ..utils.tree import leaves as _leaves
from ..utils.tree import rebuild as _tree_rebuild
from .engine import EngineFailed, ServingEngine
from .integrity import (CANARY_PROMPT, IntegrityError, fp_digest,
                        golden_trace)
from .kv_store import KVBlockStore
from .prefix_cache import chain_keys
from .tenancy import TenantQuotaExceeded, WFQueue

__all__ = [
    "ServingFleet", "FleetHandle", "FleetSaturated", "RequestJournal",
    "DeadlineExceeded", "FleetTimeout", "run_fleet_subprocess",
    "SchedulerHook", "RolloutAborted", "save_weights", "load_weights",
    "TenantQuotaExceeded", "IntegrityError",
]


class SchedulerHook(object):
    """Seam contract for deterministic schedule exploration.

    The fleet's protocol bugs live in interleavings — a handshake
    racing a demotion racing a close. This hook is the controlled-
    scheduler seam (CHESS-lite, Musuvathi et al.): the fleet calls it
    at every thread-handoff point, and a controlling implementation
    (`paddle_tpu_torch.analysis.sched_explore.ControlledScheduler`) can park
    each thread there and enumerate who runs next. The default
    (`scheduler_hook=None`) costs one `is not None` test per point.

    Contract — every yield point is OUTSIDE all fleet locks, so a
    parked thread never blocks another thread's lock acquisition:

      thread_started(kind, name)  first call on a fleet-owned thread
                                  ("replica"/"monitor"), before any
                                  yield_point; `name` is unique per
                                  incarnation (e.g. "r0.i2", "mon")
      yield_point(point)          a handoff point was reached; may
                                  block until the scheduler grants the
                                  thread its turn. Points: "replica:
                                  <name>:sync" (before the scheduler
                                  handshake), "replica:<name>:step"
                                  (before an engine step),
                                  "monitor:sweep" (before a monitor
                                  pass), "journal:flush" (before the
                                  journal file write), "submit:commit"
                                  (between a submit's durable journal
                                  write and its routing critical
                                  section — the close()-race window),
                                  "engine:<replica_id>:step" (inside
                                  `ServingEngine.step`)
      thread_exiting()            last call on the thread (crash paths
                                  included), so a controller never
                                  waits on a dead thread
      thread_spawning(name)       NON-BLOCKING notice, called on the
                                  SPAWNING thread just before a new
                                  fleet thread starts (a scale-up, a
                                  rollout refill): `name` is the exact
                                  name the new thread will register
                                  under. Lets a controller account for
                                  the thread synchronously — without
                                  it, the gap between start() and the
                                  new thread's own registration would
                                  make recorded schedules racy. May be
                                  called while fleet locks are held,
                                  so it MUST NOT block

    A hook must tolerate calls from UNREGISTERED threads (the caller's
    own submit/close run on threads the fleet never started) — the
    no-op base ignores everything.
    """

    def thread_started(self, kind: str, name: str):
        pass

    def thread_spawning(self, name: str):
        pass

    def yield_point(self, point: str):
        pass

    def thread_exiting(self):
        pass


# Test-only protocol mutants (tests/test_torch_sched_explore.py): each
# name re-opens a REAL post-merge review bug behind a flag so the
# schedule explorer / journal verifier can prove they catch it —
# CHESS-style regression seeding. Never set outside tests:
#   "superseded_report"  _accept skips the in-flight check that refuses
#                        a completion for work this replica no longer
#                        tracks (the demote -> survivor-death ->
#                        route-back fence hole: the stale report's
#                        tokens double-prepend the resume prefix)
#   "double_reject"      _reject_locked skips its idempotence guard
#                        (the close()-race double count: rejected
#                        increments twice, stats()['lost'] goes
#                        negative, the journal gets a second terminal)
_MUTANTS: Set[str] = set()

# replica lifecycle states
_LIVE, _DRAINING, _DRAINED, _DEAD = "live", "draining", "drained", "dead"
# gray-failure state: alive and heartbeating, but too slow —
# drained of work, probed, and restored (not killed) when healthy again
_DEMOTED = "demoted"
# elastic state: a slot with no running replica — either it
# never started (capacity held back for scale-up) or the autoscaler
# drained and retired it (stats folded, thread exited). Scale-up (or an
# operator refill()) brings it back as a fresh incarnation.
_RETIRED = "retired"

# per-replica stats that are GAUGES (a dead incarnation's value is
# meaningless going forward): never folded into cumulative _stats_base.
# The construction labels (paged_kernel, kv_quant, weight_quant) are
# non-numeric gauges: folding them would TypeError on replica death
_GAUGE_STATS = ("kv_blocks_in_use", "step_ewma_s", "busy",
                "paged_kernel", "kv_quant", "weight_quant")


def _lower_median(xs: List[float]) -> Optional[float]:
    """LOWER median of the LATENCY samples (lower = healthier): with
    two live replicas the upper median IS the slow one, and nothing
    would ever look slow relative to it. Shared by the demotion and
    restore thresholds so they cannot silently diverge."""
    if not xs:
        return None
    return sorted(xs)[(len(xs) - 1) // 2]


def _upper_median(xs: List[float]) -> Optional[float]:
    """UPPER median of the RATE samples — polarity is the INVERSE of
    latency (higher = healthier): with two busy replicas the lower
    median IS the gray one's trickle, and judging it against its own
    rate would veto demotion forever."""
    if not xs:
        return None
    return sorted(xs)[len(xs) // 2]

_DEFAULT_SLO_CLASSES = {
    # interactive: one prefill chunk per step fleet-wide per replica —
    # the flattest decode latency for that replica's neighbors (TTFT of
    # long prompts pays); batch: every pending slot advances (highest
    # prefill throughput, decode latency of neighbors pays)
    "interactive": {"max_prefills_per_step": 1},
    "batch": {"max_prefills_per_step": None},
}

_DEFAULT_TIER_CLASSES = {
    # prefill tier: every pending slot advances a chunk per step —
    # maximum prefill throughput, and its decode latency does not
    # matter because requests MIGRATE OUT at first token; decode tier:
    # at most one prefill chunk per step (only the resume re-prefill of
    # migrated-in work runs here), keeping the batched decode cadence
    # flat — the disaggregation split (DistServe/Splitwise lineage)
    "prefill": {"max_prefills_per_step": None},
    "decode": {"max_prefills_per_step": 1},
}


class FleetSaturated(RuntimeError):
    """`submit()` refused: the fleet already holds `max_pending` open
    requests. Explicit load-shed — retry later or scale out; the fleet
    never grows an unbounded admission queue."""


class DeadlineExceeded(RuntimeError):
    """Terminal per-request verdict: the request's
    `deadline_s` budget ran out before it could finish. Raised by
    `submit()` when the deadline is already spent on arrival (checked
    BEFORE the `FleetSaturated` shed, so overload metrics never absorb
    client-side lateness), and by `FleetHandle.result()` when the
    request expired at a later queue hop. The journal records the
    expiry — a verdict, never a silent hang — and `tokens` carries
    whatever was emitted before the budget died."""

    def __init__(self, msg: str, rid=None, tokens=None):
        super().__init__(msg)
        self.rid = rid
        self.tokens = list(tokens) if tokens else []


class FleetTimeout(TimeoutError):
    """`FleetHandle.result(timeout=...)` ran out of caller patience —
    NOT a fleet verdict: the request is still open. Carries the fleet
    context an operator needs to tell a slow request from a lost one:
    rid, the journal state (queued / assigned / decoding), the replica
    currently holding the assignment, and how many tokens have been
    emitted so far."""

    def __init__(self, msg: str, rid=None, state=None, replica=None,
                 tokens_emitted=0):
        super().__init__(msg)
        self.rid = rid
        self.state = state
        self.replica = replica
        self.tokens_emitted = tokens_emitted


class RequestCancelled(RuntimeError):
    """Terminal CLIENT verdict: the request was cancelled
    by its submitter — a dropped wire connection, an explicit cancel
    frame, or a direct `ServingFleet.cancel()` call — before the fleet
    finished it. The journal records a `cancelled` terminal (the DFA
    accepts it as closed), every engine-side slot and KV block the
    request held is clawed back through the same cancel path demotion
    hedging uses, and `tokens` carries the journaled prefix emitted
    before the cancel landed. Distinct from `expired` (the FLEET's
    deadline verdict) so shed/SLO metrics never blame the fleet for an
    abandoned stream."""

    def __init__(self, msg: str, rid=None, tokens=None):
        super().__init__(msg)
        self.rid = rid
        self.tokens = list(tokens) if tokens else []


class RolloutAborted(RuntimeError):
    """`roll_weights()` refused to start: the candidate checkpoint
    failed its CRC/metas verification (or no known-good step exists).
    The fleet is UNTOUCHED — no replica was drained, every replica
    still serves the previous weights version. Carries the per-file
    evidence in `problems`."""

    def __init__(self, msg: str, problems=None):
        super().__init__(msg)
        self.problems = list(problems or [])


class _KillDrill(RuntimeError):
    """Injected replica death (ServingFleet.kill_replica)."""


class FleetHandle(object):
    """Per-request future filled in by whichever replica completes the
    request (possibly a survivor after failover). Thread-safe: waiters
    block on an event, never by driving an engine."""

    def __init__(self, rid: int, prompt: np.ndarray, spec: dict,
                 slo: Optional[str], fleet=None, deadline_at=None):
        self.rid = rid
        self.prompt = prompt  # np.int32 [T0]
        self.spec = spec      # JSON-able request record (journal form)
        self.slo = slo
        self.generation = 0   # bumped on every resubmission
        # absolute time.monotonic() budget (None = none); journaled as
        # (deadline_s, submit_unix) so a recovered front door can
        # recompute the remaining budget across a process restart
        self.deadline_at = deadline_at
        # tokens already emitted by a dead/demoted incarnation; the
        # next assignee prefill-aliases these and decodes ONLY the
        # remainder (token-level resume). Replaced wholesale (never
        # mutated in place) under the fleet lock at re-route time.
        self.resume: List[int] = []
        # running count of journaled emitted tokens (resume included) —
        # cheap operator context for FleetTimeout
        self.emitted = 0
        self.ttft_s: Optional[float] = None  # first journaled token
        self.tokens: Optional[List[int]] = None
        self.replica: Optional[str] = None  # who answered
        # live-rollout version fence: the weights_version of
        # the replica that COMPLETED this request (None when the fleet
        # is unversioned, or when the answer came straight from
        # journaled progress of a holder whose version is unrecorded)
        self.weights_version: Optional[int] = None
        self.error: Optional[BaseException] = None
        self.chain: List[int] = []  # affinity keys (set by the fleet)
        # multi-tenant side-band: the admitting tenant
        # (None on a single-tenant fleet), the WFQ service-cost
        # estimate, and — for batch-lane (zoo) jobs — the host
        # callable a replica runs between engine steps plus its return
        # value. All set by the fleet at submit time.
        self.tenant: Optional[str] = None
        self.cost: float = 1.0
        self.batch_fn = None
        self.batch_result = None
        # durable-KV handoff: the block package fetched from
        # the fleet store at re-route (consumed by the assignee's
        # submit) and the journal side-band describing it ({"len",
        # "digest"} — stamped onto the assign record, the J011 fence).
        # Both replaced wholesale under the fleet lock at re-route.
        self.handoff_package: Optional[list] = None
        self.handoff_meta: Optional[dict] = None
        self._probe = False   # internal health probe, never journaled
        # known-answer canary: a _probe-shaped request on a
        # LIVE replica whose completion is judged against the golden
        # trace instead of the demotion-restore machinery
        self._canary = False
        # wire/streaming side-band: the front-door
        # connection id this request arrived on (None for direct
        # Python callers) and whether the caller asked for incremental
        # delivery. Both journaled on the submit record (typed by the
        # DFA's J008 rule) so a wire-level FleetTimeout names them.
        self.conn: Optional[str] = None
        self.streaming = False
        # journal-accumulation index already queued to the stream —
        # written only under the FLEET lock (guarded-by: fleet._cond),
        # so pushes are ordered exactly like the journal mirror
        self._stream_sent = 0
        # delivered-token buffer + close flag; its own leaf lock
        # (guarded-by: _stream_cv — taken inside fleet._cond at feed
        # time, never the other way) so iterators never touch the
        # scheduler lock. Tokens land here only AFTER the journal
        # records describing them are on disk (the _flush_journal
        # read-your-writes discipline, same as _event).
        self._stream_buf: List[int] = []   # guarded-by: _stream_cv
        self._stream_closed = False        # guarded-by: _stream_cv
        self._stream_cv = threading.Condition()
        self._fleet = fleet
        self._submit_t = time.monotonic()
        self._event = threading.Event()

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._event.wait(timeout)

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request completes somewhere in the fleet;
        returns prompt + generated tokens. Raises `EngineFailed` if the
        fleet lost every replica (or was closed) with this request
        pending, `DeadlineExceeded` if the request's budget expired,
        and `FleetTimeout` — carrying rid, journal state, assigned
        replica, and tokens emitted so far — when the CALLER's timeout
        runs out with the request still open."""
        if not self._event.wait(timeout):
            ctx = (self._fleet._describe(self.rid)
                   if self._fleet is not None else {})
            raise FleetTimeout(
                "request %d not completed within %r s: %s "
                "(%d token(s) emitted so far)" % (
                    self.rid, timeout,
                    ctx.get("describe", "state unknown"),
                    ctx.get("tokens_emitted", self.emitted)),
                rid=self.rid, state=ctx.get("state"),
                replica=ctx.get("replica"),
                tokens_emitted=ctx.get("tokens_emitted", self.emitted))
        if self.error is not None:
            raise self.error
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])

    def _stream_feed(self, tokens: List[int], closing: bool):
        """Deliver journaled tokens to stream iterators (called by the
        fleet AFTER the journal flush wrote the records describing
        them — never under `fleet._cond`). Idempotent past close: a
        handle swept by close() may see a second deferred close from
        the flush straggler; once closed, nothing changes."""
        with self._stream_cv:
            if self._stream_closed:
                return
            if tokens:
                self._stream_buf.extend(int(t) for t in tokens)
            if closing:
                self._stream_closed = True
            self._stream_cv.notify_all()

    def stream_chunks(self, timeout: Optional[float] = None):
        """Incremental delivery: yield lists
        of newly journaled generated tokens as the fleet's batched
        journal flushes land them — one chunk per flushed progress
        batch, so wire framing rides the journal's own cadence. The
        concatenation of every chunk is bit-identical to the generated
        half of `result()` for every request, across failover and
        migration: chunks are fed from the SAME fenced, exactly-once
        journal mirror failover resumes from, so a spliced stream is
        the resumed prefix plus the survivor's deltas — never a
        re-decoded or interleaved token. Terminal errors (deadline,
        reject, cancel, fleet death) raise HERE after the delivered
        prefix, exactly like `result()` would; `timeout` bounds the
        wait for each NEXT chunk and raises `FleetTimeout` with the
        fleet's describe context."""
        sent = 0
        while True:
            with self._stream_cv:
                while (sent >= len(self._stream_buf)
                        and not self._stream_closed):
                    if not self._stream_cv.wait(timeout):
                        ctx = (self._fleet._describe(self.rid)
                               if self._fleet is not None else {})
                        raise FleetTimeout(
                            "stream for request %d idle for %r s: %s "
                            "(%d token(s) delivered so far)" % (
                                self.rid, timeout,
                                ctx.get("describe", "state unknown"),
                                sent),
                            rid=self.rid, state=ctx.get("state"),
                            replica=ctx.get("replica"),
                            tokens_emitted=ctx.get(
                                "tokens_emitted", sent))
                chunk = self._stream_buf[sent:]
                closed = self._stream_closed
            if chunk:
                sent += len(chunk)
                yield chunk
            if closed and sent >= len(self._stream_buf):
                break
        # the close fed by a terminal always trails its _event/error
        # publication, so a drained stream can report the verdict
        if self.error is not None:
            raise self.error

    def stream(self, timeout: Optional[float] = None):
        """Per-token view of `stream_chunks()` — yields ints."""
        for chunk in self.stream_chunks(timeout=timeout):
            for t in chunk:
                yield t

    def cancel(self) -> bool:
        """Client-side cancel: ask the fleet to stop this
        request. Returns False when it already went terminal."""
        if self._fleet is None:
            return False
        return self._fleet.cancel(self.rid)


_TERMINAL_KINDS = ("done", "rejected", "expired", "cancelled")

# submit(slo=...)'s "caller said nothing" sentinel: distinguishes the
# implicit default ("interactive", or the tenant's registered default
# class on a multi-tenant fleet) from an EXPLICIT slo=None (wildcard —
# any replica class). A plain string default could not tell the two
# apart, and the tenant default would be unreachable.
_SLO_UNSET = object()


class RequestJournal(object):
    """Durable request table: every submit/assign/progress/terminal
    (done / rejected / expired) transition is appended (JSON lines)
    BEFORE the fleet acts on it, and mirrored in memory as the
    authoritative OPEN-request index (terminal records prune their
    mirror entries, so memory is bounded by in-flight work, not
    lifetime traffic). Failover reads the journal mirror —
    `lost(replica, incarnation)`, which now carries the PROGRESS
    tokens for token-level resume — not scheduler guesswork. Opening
    an EXISTING journal replays it: the mirror resumes the open set
    and `next_rid()` continues past every rid ever issued, so a
    restarted front door appending to the same file can never collide
    with (and thereby corrupt) the history. `path=None` keeps the
    mirror only (tests); `recover(path)` is the read-only restart
    helper.

    Durability: records are flushed per append (they survive any
    process death — the failure mode the fleet handles). `fsync=True`
    additionally fsyncs each record for OS-crash/power-loss
    durability, at per-request disk latency cost.

    Compaction: per-token progress records make an
    append-only file grow with lifetime TRAFFIC, not in-flight work.
    With `compact_every=N`, once the file holds >= N records (and the
    rewrite would actually shrink it) the journal atomically rewrites
    itself to just a meta record (preserving the rid history) plus the
    open requests' submit/assign/progress state — `recover()` after a
    compaction sees exactly the same open set."""

    def __init__(self, path: Optional[str] = None, fsync: bool = False,
                 compact_every: Optional[int] = None):
        self._lock = threading.Lock()
        self.path = path
        self.fsync = bool(fsync)
        if compact_every is not None and int(compact_every) < 1:
            raise ValueError("compact_every must be >= 1 or None")
        self.compact_every = (
            None if compact_every is None else int(compact_every))
        self.compactions = 0                         # guarded-by: _lock
        self._file_records = 0                       # guarded-by: _lock
        self._open_specs: Dict[int, dict] = {}       # guarded-by: _lock
        self._assign: Dict[int, Tuple[str, int, int]] = {}  # guarded-by: _lock
        # (tier, weights_version, tenant) side-band of the latest
        # assignment: kept apart from _assign so the
        # 3-tuple fence consumers stay unchanged; compaction must
        # reproduce it
        self._assign_meta: Dict[int, Tuple[Optional[str], Optional[int], Optional[str]]] = {}  # guarded-by: _lock
        self._progress: Dict[int, List[int]] = {}    # guarded-by: _lock
        # taint side-band: open rids whose journaled
        # progress was truncated by an integrity record — rid ->
        # (replica, incarnation, from, upto). Compaction must
        # reproduce these (the J010 re-decode audit spans rotations);
        # terminal records prune them like every other mirror entry
        self._taint: Dict[int, Tuple[str, int, int, int]] = {}  # guarded-by: _lock
        self._done: Set[int] = set()                 # guarded-by: _lock
        # records handed out via defer=True whose file append is still
        # pending in the caller: while any are outstanding the mirror
        # is AHEAD of the file, so no compaction may snapshot it
        self._deferred_out = 0                       # guarded-by: _lock
        self._max_rid = -1                           # guarded-by: _lock
        # True when this journal object REOPENED an existing file (a
        # restarted front door): its predecessor's unterminated rids
        # legitimately stay open forever, so the close()-audit must not
        # assert the everything-terminal invariant over them
        self.preexisting = bool(path and os.path.exists(path))
        if self.preexisting:
            self._replay_and_heal(path)
        self._f = open(path, "a") if path else None  # guarded-by: _lock

    @staticmethod
    def _read(path: str):
        """Parse a journal file, tolerating a TORN FINAL line (the
        process died mid-append — the crash this journal exists to
        survive must not make it unreadable). A malformed line
        followed by valid records is real corruption and raises."""
        pending_error = None
        with open(path) as f:
            for lineno, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                if pending_error is not None:
                    raise ValueError(
                        "corrupt journal %s: unparseable line %d is "
                        "not a torn tail" % (path, pending_error))
                try:
                    rec = json.loads(line)
                except ValueError:
                    pending_error = lineno  # torn IF nothing follows
                    continue
                yield rec

    def _replay_and_heal(self, path: str):
        """Replay an existing journal into the mirror and TRUNCATE a
        torn final line: reopening in append mode would otherwise glue
        the next record onto the partial text, turning a tolerated
        torn tail into mid-file corruption for every later reader."""
        good_end = 0
        torn_at = None
        with open(path, "rb") as f:
            for lineno, raw in enumerate(f.readlines(), 1):
                line = raw.decode("utf-8", "replace").strip()
                if not line:
                    if torn_at is None:
                        good_end += len(raw)
                    continue
                if torn_at is not None:
                    raise ValueError(
                        "corrupt journal %s: unparseable line %d is "
                        "not a torn tail" % (path, torn_at))
                try:
                    rec = json.loads(line)
                except ValueError:
                    torn_at = lineno
                    continue
                self._replay(rec)
                self._file_records += 1
                good_end += len(raw)
        if torn_at is not None:
            with open(path, "r+b") as f:
                f.truncate(good_end)

    def _replay(self, rec: dict):
        if rec["kind"] == "meta":  # compaction marker: rid history
            self._max_rid = max(self._max_rid, rec["max_rid"])
            return
        if rec["kind"] == "integrity":  # taint side-band
            self._apply_taint(rec["replica"], rec["incarnation"],
                              {int(r): (w[0], w[1])
                               for r, w in rec["taint"].items()})
            return
        rid = rec["rid"]
        self._max_rid = max(self._max_rid, rid)
        if rec["kind"] == "submit":
            self._open_specs[rid] = rec["spec"]
        elif rec["kind"] == "assign":
            self._assign[rid] = (rec["replica"], rec["incarnation"],
                                 rec["gen"])
            self._assign_meta[rid] = (rec.get("tier"),
                                      rec.get("weights_version"),
                                      rec.get("tenant"),
                                      rec.get("handoff"))
        elif rec["kind"] == "progress":
            self._progress.setdefault(rid, []).extend(rec["tokens"])
        elif rec["kind"] in _TERMINAL_KINDS:
            self._done.add(rid)
            self._open_specs.pop(rid, None)
            self._assign.pop(rid, None)
            self._assign_meta.pop(rid, None)
            self._progress.pop(rid, None)
            self._taint.pop(rid, None)

    def _append(self, rec: dict, flush: bool = True):
        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
            self._file_records += 1
            if flush:
                self._flush_file()
                # auto-compaction only at a batch boundary (here =
                # single-record batch): the snapshot is built from the
                # MIRROR, which already holds the effects of deferred
                # records not yet appended — compacting mid-batch
                # would write those effects AND then append the
                # records on top, duplicating progress tokens in the
                # file (wrong resume prefixes after a restart)
                self._maybe_compact()

    def _flush_file(self):  # holds: _lock
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())

    def _open_records(self) -> List[dict]:
        """The records a compaction must preserve: one meta record (the
        rid history, so next_rid() survives the rewrite) plus each open
        request's submit, latest assign, and accumulated progress —
        and, for rids inside an active taint window, the consolidated
        `integrity` side-band (grouped by quarantined holder), so the
        J010 re-decode audit still knows which token indices are
        sanctioned to re-decode after a rotation."""
        recs: List[dict] = [{"kind": "meta", "max_rid": self._max_rid}]
        for rid in sorted(self._open_specs):
            recs.append({"kind": "submit", "rid": rid,
                         "spec": self._open_specs[rid]})
            # consolidated progress BEFORE the re-emitted assignment:
            # the verifier's handoff fence (J011) anchors a package-
            # carrying assign against the history that precedes it —
            # progress-first keeps the re-route shape of the live file
            # (tokens journaled, then the new holder assigned)
            if self._progress.get(rid):
                recs.append({"kind": "progress", "rid": rid,
                             "replica": None, "incarnation": None,
                             "gen": None,
                             "tokens": list(self._progress[rid])})
            if rid in self._assign:
                rep, inc, gen = self._assign[rid]
                tier, wv, ten, ho = self._assign_meta.get(
                    rid, (None, None, None, None))
                recs.append({"kind": "assign", "rid": rid, "replica": rep,
                             "incarnation": inc, "gen": gen,
                             "tier": tier, "weights_version": wv,
                             "tenant": ten,
                             # the handoff side-band survives rotation:
                             # the J011 fence must still tie the open
                             # rid's eventual done to THIS transfer
                             "handoff": ho})
        by_holder: Dict[Tuple[str, int], Dict[int, Tuple[int, int]]] = {}
        for rid, (rep, inc, frm, upto) in self._taint.items():
            if rid not in self._open_specs:
                continue
            # emit only the REMAINING sanctioned span: the consolidated
            # progress record above already reflects the truncation
            # (plus any re-decode the survivor journaled since), so
            # replaying this record must truncate NOTHING — a window
            # anchored at the original `from` would discard the
            # survivor's verified re-decode on restart. Fully-consumed
            # windows were already dropped by progress(); this guards
            # the same invariant for windows consumed between there
            # and the snapshot
            cur = len(self._progress.get(rid, []))
            lo = max(frm, cur)
            if lo < upto:
                by_holder.setdefault((rep, inc), {})[rid] = (lo, upto)
        for (rep, inc) in sorted(by_holder):
            recs.append({
                "kind": "integrity", "replica": rep, "incarnation": inc,
                "taint": {str(r): [f, u] for r, (f, u)
                          in sorted(by_holder[(rep, inc)].items())}})
        return recs

    def _maybe_compact(self):  # holds: _lock
        """Auto-rotation: rewrite once the file crosses the threshold —
        but only when the rewrite actually SHRINKS it (a fleet whose
        open set alone exceeds the threshold must not rewrite the whole
        file on every append), and never while deferred records are
        outstanding (a direct append — e.g. submit — can land while
        another thread holds mirror-applied-but-unwritten progress
        records: the snapshot would write those tokens AND the later
        write() would append the same deltas on top, duplicating
        progress in the file and corrupting restart resume prefixes)."""
        if self.compact_every is None or self._f is None:
            return
        if self._deferred_out > 0:
            return
        if self._file_records < self.compact_every:
            return
        if self._file_records < 2 * (3 * len(self._open_specs) + 1):
            return
        self._compact_locked()

    def _compact_locked(self):  # holds: _lock
        recs = self._open_records()
        tmp = self.path + ".compact"
        with open(tmp, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)  # atomic: crash keeps old OR new
        self._f = open(self.path, "a")
        self._file_records = len(recs)
        # _done is KEPT: is_done() must stay truthful across rotations
        # (ints only — bounded by lifetime, like the fleet's own
        # _done_rids dedupe set)
        self.compactions += 1

    def compact(self) -> bool:
        """Explicit rewrite-to-open-set (see class docstring). Returns
        False for a mirror-only journal, or while deferred records are
        outstanding (the mirror is ahead of the file — see
        _maybe_compact; retry after the pending write())."""
        with self._lock:
            if self._f is None or self._deferred_out > 0:
                return False
            self._compact_locked()
            return True

    def next_rid(self) -> int:
        """First rid safe to issue: past everything this journal file
        has ever seen (restart-collision guard)."""
        with self._lock:
            return self._max_rid + 1

    def submit(self, rid: int, spec: dict,
               conn: Optional[str] = None, stream: bool = False):
        """`conn`/`stream` are the wire side-band: the
        front-door connection id the request arrived on and whether
        the caller asked for incremental delivery — typed by the DFA
        (J008), absent entirely for direct Python submits so old
        journals stay valid byte-for-byte."""
        rec = {"kind": "submit", "rid": rid, "spec": spec}
        if conn is not None:
            rec["conn"] = str(conn)
        if stream:
            rec["stream"] = True
        with self._lock:
            self._open_specs[rid] = spec
            self._max_rid = max(self._max_rid, rid)
            self._append(rec)

    def assign(self, rid: int, replica: str, incarnation: int, gen: int,
               tier: Optional[str] = None,
               weights_version: Optional[int] = None,
               tenant: Optional[str] = None,
               handoff: Optional[dict] = None,
               defer: bool = False) -> Optional[dict]:
        """Record an assignment. The MIRROR updates synchronously (a
        failover consulting `lost()` an instant later must see it);
        with `defer=True` the file append is returned as a record for
        the caller to `write()` later — the fleet defers file I/O
        until it has released its scheduler lock. `tier`,
        `weights_version`, and `tenant` ride as an optional side-band:
        the assignee's disaggregation tier, the
        weight version it serves — the journal DFA's version fence
        (J009) checks every done record against its latest
        assignment's version — and the tenant whose quota admitted
        the request (typed by the DFA: an ill-typed tenant is J008),
        so a per-tenant exactly-once audit can group the journal by
        consumer. `handoff` records that this assignment
        ships a durable-KV block package — {"len": imported-prefix
        tokens, "digest": fp_digest of the chain} — the J011 handoff
        fence's assign half: the eventual done must account for the
        transfer (verified import or counted fallback)."""
        rec = {"kind": "assign", "rid": rid, "replica": replica,
               "incarnation": incarnation, "gen": gen,
               "tier": tier, "weights_version": weights_version,
               "tenant": tenant}
        if handoff is not None:
            rec["handoff"] = dict(handoff)
        with self._lock:
            self._assign[rid] = (replica, incarnation, gen)
            self._assign_meta[rid] = (tier, weights_version, tenant,
                                      handoff)
            if defer:
                self._deferred_out += 1
                return rec
            self._append(rec)
        return None

    def _terminal(self, rid: int, rec: dict,
                  defer: bool) -> Optional[dict]:
        """Shared body of every terminal kind (done/expired/rejected):
        mark the rid done, prune it from the open mirror, then append
        the record (or hand it back deferred)."""
        with self._lock:
            self._done.add(rid)
            self._open_specs.pop(rid, None)
            self._assign.pop(rid, None)
            self._assign_meta.pop(rid, None)
            self._progress.pop(rid, None)
            self._taint.pop(rid, None)
            if defer:
                self._deferred_out += 1
                return rec
            self._append(rec)
        return None

    def _apply_taint(self, replica: str, incarnation: int,
                     taint: Dict[int, Tuple[int, int]]):  # holds: _lock
        """Mirror effect of one integrity record: truncate each tainted
        rid's accumulated progress back to its verified index `from`,
        so `lost()`/`progress_of()` hand failover the CLEAN prefix and
        the taint window [from, upto) re-decodes on the survivor."""
        for rid, (frm, upto) in taint.items():
            rid = int(rid)
            cur = self._progress.get(rid)
            if cur is not None:
                self._progress[rid] = cur[:int(frm)]
            if rid in self._open_specs:
                self._taint[rid] = (replica, int(incarnation),
                                    int(frm), int(upto))

    def integrity(self, replica: str, incarnation: int,
                  taint: Dict[int, Tuple[int, int]], reason=None,
                  defer: bool = False) -> Optional[dict]:
        """Integrity quarantine record: replica
        (replica, incarnation) tripped the serving sentinel, and every
        journaled progress token it produced since its last clean
        canary is TAINTED. `taint` maps rid -> (from, upto): token
        indices [from, upto) of that rid's accumulated progress are
        suspect. The MIRROR truncates each rid's progress to `from`
        synchronously (the failover an instant later resumes from the
        verified prefix — the one sanctioned exception to the
        zero-re-decode rule), and the DFA's J010 audits that ONLY
        indices inside a journaled taint window ever re-decode."""
        rec = {"kind": "integrity", "replica": str(replica),
               "incarnation": int(incarnation),
               "taint": {str(int(r)): [int(f), int(u)]
                         for r, (f, u) in sorted(taint.items())}}
        if reason is not None:
            rec["reason"] = str(reason)
        with self._lock:
            self._apply_taint(str(replica), int(incarnation),
                              {int(r): (int(f), int(u))
                               for r, (f, u) in taint.items()})
            if defer:
                self._deferred_out += 1
                return rec
            self._append(rec)
        return None

    def taint_of(self, rid: int) -> Optional[Tuple[str, int, int, int]]:
        """(replica, incarnation, from, upto) of the rid's active taint
        window, or None."""
        with self._lock:
            return self._taint.get(rid)

    def complete(self, rid: int, replica: str, incarnation: int,
                 gen: int, tokens: List[int],
                 weights_version: Optional[int] = None,
                 tenant: Optional[str] = None,
                 handoff: Optional[dict] = None,
                 defer: bool = False) -> Optional[dict]:
        rec = {"kind": "done", "rid": rid, "replica": replica,
               "incarnation": incarnation, "gen": gen,
               "tokens": list(tokens)}
        if handoff is not None:
            # the J011 fence's done half: what became of the block
            # package the latest assignment shipped — {"imported":
            # tokens imported clean, "fallback": any re-prefill}
            rec["handoff"] = dict(handoff)
        if weights_version is not None:
            # the version fence's done half: which weights produced
            # this output (must equal the latest assignment's — J009)
            rec["weights_version"] = int(weights_version)
        if tenant is not None:
            # the tenant side-band's done half: which
            # consumer this verdict answered — typed by the DFA (J008)
            rec["tenant"] = str(tenant)
        return self._terminal(rid, rec, defer)

    def progress(self, rid: int, replica: str, incarnation: int,
                 gen: int, tokens: List[int],
                 conn: Optional[str] = None, stream: bool = False,
                 defer: bool = False) -> Optional[dict]:
        """Incremental emitted-token record (token-level resume):
        `tokens` is the DELTA since the last progress record
        for this rid. Batched by the fleet (one record per scheduler
        handshake, not per token) and flush-deferred like assign —
        the mirror is what failover resumes from. For a STREAMED
        request, the record carries the wire side-band:
        `conn` and the `stream` CURSOR — the accumulated journaled
        length after this delta, i.e. exactly how many generated
        tokens a front door restarted off this file may have already
        delivered to the client (typed by the DFA's J008 rule)."""
        rec = {"kind": "progress", "rid": rid, "replica": replica,
               "incarnation": incarnation, "gen": gen,
               "tokens": [int(t) for t in tokens]}
        if conn is not None:
            rec["conn"] = str(conn)
        with self._lock:
            acc = self._progress.setdefault(rid, [])
            acc.extend(rec["tokens"])
            if stream:
                rec["stream"] = len(acc)
            t = self._taint.get(rid)
            if t is not None and len(acc) >= t[3]:
                # the survivor's re-decode caught up with the taint
                # window: it is CONSUMED — a later compaction must not
                # re-emit (and replay must not re-truncate) a window
                # whose re-decode already happened
                del self._taint[rid]
            if defer:
                self._deferred_out += 1
                return rec
            self._append(rec)
        return None

    def expire(self, rid: int, tokens: List[int],
               defer: bool = False) -> Optional[dict]:
        """Terminal DEADLINE verdict: the request ran out of budget.
        Distinct from `rejected` (unservable) and `done` (answered) so
        shed/SLO metrics never conflate overload, malformed input, and
        lateness; `tokens` records what was emitted before expiry."""
        rec = {"kind": "expired", "rid": rid,
               "tokens": [int(t) for t in tokens]}
        return self._terminal(rid, rec, defer)

    def cancel(self, rid: int, tokens: List[int],
               conn: Optional[str] = None,
               defer: bool = False) -> Optional[dict]:
        """Terminal CLIENT verdict: the submitter walked
        away — a dropped wire connection or an explicit cancel frame.
        Distinct from `expired` (the fleet's own deadline) and
        `rejected` (unservable) so abandonment never pollutes shed or
        SLO metrics; `tokens` records the journaled prefix emitted
        before the cancel, `conn` the connection that owned the
        request. The DFA accepts it as closed (J007)."""
        rec = {"kind": "cancelled", "rid": rid,
               "tokens": [int(t) for t in tokens]}
        if conn is not None:
            rec["conn"] = str(conn)
        return self._terminal(rid, rec, defer)

    def write(self, recs: List[dict]):
        """File-append records whose mirror updates already happened
        (the deferred half of assign/complete/progress/expire). One
        flush per batch, not per record — and auto-compaction only
        AFTER the whole batch is on disk (see _append: a mid-batch
        snapshot would duplicate the not-yet-appended records'
        effects)."""
        with self._lock:
            for rec in recs:
                self._append(rec, flush=False)
            self._deferred_out = max(0, self._deferred_out - len(recs))
            if self._f is not None:
                self._flush_file()
                self._maybe_compact()

    def reject(self, rid: int, reason: str,
               defer: bool = False) -> Optional[dict]:
        """Terminal record for a request that can never complete (a
        malformed spec an engine refused, or no live replica to serve
        it): without it the rid would stay open forever and every
        future recover() would resubmit an unservable request."""
        rec = {"kind": "rejected", "rid": rid, "reason": reason}
        return self._terminal(rid, rec, defer)

    def lost(self, replica: str, incarnation: int
             ) -> List[Tuple[int, dict, int, List[int]]]:
        """(rid, spec, gen, emitted_tokens) of every OPEN request whose
        latest assignment is (replica, incarnation) — the set a
        failover/demotion must resubmit, with the progress tokens the
        survivor resumes from instead of re-decoding."""
        with self._lock:
            out = []
            for rid, (rep, inc, gen) in sorted(self._assign.items()):
                if rep == replica and inc == incarnation \
                        and rid in self._open_specs:
                    out.append((rid, self._open_specs[rid], gen,
                                list(self._progress.get(rid, []))))
            return out

    def assigned_to(self, rid: int) -> Optional[Tuple[str, int, int]]:
        """Latest (replica, incarnation, gen) assignment, or None. The
        completion/progress fence: only the current holder's reports
        count (the lease-generation rule, recast for request SLO)."""
        with self._lock:
            return self._assign.get(rid)

    def assigned_meta(self, rid: int
                      ) -> Tuple[Optional[str], Optional[int],
                                 Optional[str], Optional[dict]]:
        """(tier, weights_version, tenant, handoff) side-band of the
        latest assignment — all None when unassigned or unversioned.
        Lets a completion recovered straight from journaled progress
        record the version of the holder that actually produced the
        tokens, and lets _accept close the J011 handoff fence."""
        with self._lock:
            return self._assign_meta.get(rid, (None, None, None, None))

    def progress_of(self, rid: int) -> List[int]:
        with self._lock:
            return list(self._progress.get(rid, []))

    def open_count(self) -> int:
        with self._lock:
            return len(self._open_specs)

    def is_done(self, rid: int) -> bool:
        with self._lock:
            return rid in self._done

    def close(self):
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    @staticmethod
    def recover(path: str) -> List[Tuple[int, dict]]:
        """Rebuild the incomplete-request list from a journal file:
        (rid, spec) for every submitted rid with no terminal
        (done/rejected/expired) record, in submission order. A
        restarted front door resubmits exactly these — requests
        survive even a full fleet-process crash. (Use
        `recover_progress(path)` for the emitted-token prefixes and
        pass them to `ServingFleet.submit(resume_tokens=...)`.)"""
        specs: Dict[int, dict] = {}
        done: Set[int] = set()
        for rec in RequestJournal._read(path):
            if rec["kind"] == "submit":
                specs[rec["rid"]] = rec["spec"]
            elif rec["kind"] in _TERMINAL_KINDS:
                done.add(rec["rid"])
        return [(rid, specs[rid]) for rid in sorted(specs)
                if rid not in done]

    @staticmethod
    def recover_progress(path: str) -> Dict[int, List[int]]:
        """Emitted-token prefixes of the incomplete requests (rid ->
        tokens, in emission order): the restart counterpart of the
        in-process resume path — resubmit recover()'s specs via
        `ServingFleet.submit(..., resume_tokens=these[rid])` and no
        decode step is re-spent."""
        open_set = {rid for rid, _ in RequestJournal.recover(path)}
        prog: Dict[int, List[int]] = {}
        for rec in RequestJournal._read(path):
            if rec["kind"] == "progress" and rec["rid"] in open_set:
                prog.setdefault(rec["rid"], []).extend(rec["tokens"])
            elif rec["kind"] == "integrity":
                # taint truncation applies across restarts too: a
                # restarted front door must not resume a corrupt
                # replica's tainted suffix
                for rid_s, (frm, _upto) in rec["taint"].items():
                    rid = int(rid_s)
                    if rid in prog:
                        prog[rid] = prog[rid][:int(frm)]
        return prog


class _FlatScope(object):
    """Checkpoint-scope adapter over a flat {name: array} dict — the
    bridge between a model params pytree and the training checkpoint
    machinery (save_checkpoint / load_checkpoint verify CRCs per
    entry; the scope protocol is keys/get/set)."""

    def __init__(self, arrays):
        self._arrays = arrays

    def keys(self):
        return self._arrays.keys()

    def get(self, name):
        return self._arrays.get(name)

    def set(self, name, val):
        self._arrays[name] = val


def _flat_names(params):
    """Positional leaf naming for a params tree: stable across save
    and load because both sides flatten the SAME tree structure, in
    jax.tree_util's leaf order (dictionary keys sorted), so the two
    packages name the leaves of one model alike — no keypath escaping,
    and a checkpoint from a different model shows up as a count/shape
    mismatch, never a silent misload."""
    leaves = _leaves(params)
    return ["w%05d" % k for k in range(len(leaves))], leaves


def _leaf_like(arr, like):
    """One loaded host array as a tensor shaped, typed and placed like
    the construction leaf `like`. A bfloat16 leaf written by the JAX
    package reads back as 2-byte raw records (numpy has no bfloat16):
    its bits are taken as bfloat16. The port writes bfloat16 as float32,
    which casts back exactly."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)
                             .copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def save_weights(params, ckpt_dir: str, step: int, keep_last: int = 8,
                 protect=None) -> dict:
    """Write one weight version under `ckpt_dir/step_<N>/` with the
    training checkpoint machinery (CRC sidecars, atomic meta commit) —
    the PUSH half of the reference's pserver push/pull recast as
    checkpoint promotion: a training job (or its sentinel, which
    promotes known-good steps) saves here, and
    `ServingFleet.roll_weights(step)` rolls the fleet onto it after
    the same CRC walk `resume_or_init` trusts. The layout is the JAX
    package's: either package's fleet rolls onto the other's weight
    sets (bfloat16 leaves are written as float32). Returns the save
    meta."""
    from ..distributed.checkpoint import save_checkpoint

    names, leaves = _flat_names(params)
    return save_checkpoint(_FlatScope(dict(zip(names, leaves))), ckpt_dir,
                           step=int(step), keep_last=keep_last,
                           protect=protect)


def load_weights(like, ckpt_dir: str, step: int):
    """Load one checkpoint step written by `save_weights` (of either
    package) into a fresh params tree shaped exactly like `like`: each
    leaf on `like`'s leaf's device and in its dtype (a bfloat16 model
    stays bfloat16 whatever the file holds), complete on the device
    before it returns. Positional leaf naming; a checkpoint whose leaf
    count or shapes disagree is a `RolloutAborted`, never a silent
    misload. `ServingFleet.roll_weights` loads its candidate with this,
    after the CRC walk."""
    from ..distributed.checkpoint import load_checkpoint

    names, leaves = _flat_names(like)
    arrays: Dict[str, Any] = {}
    load_checkpoint(_FlatScope(arrays), ckpt_dir, step=int(step))
    if sorted(arrays) != names:
        foreign = sorted(set(arrays) - set(names))
        if foreign:
            # entry names are not save_weights' positional leaf names:
            # this is some other checkpoint (e.g. a raw training
            # save_checkpoint scope) — name the REAL mismatch, not a
            # leaf count that may coincide
            raise RolloutAborted(
                "checkpoint step %d was not written by "
                "save_weights (entries like %r, expected "
                "positional leaf names w00000...w%05d) — publish "
                "serving weight sets with save_weights(params, "
                "ckpt_dir, step)" % (int(step), foreign[0],
                                     len(names) - 1))
        raise RolloutAborted(
            "checkpoint step %d holds %d weight leaf(s), the "
            "serving model has %d — not a weight set for this "
            "model" % (int(step), len(arrays), len(names)))
    new_leaves = []
    for n, old in zip(names, leaves):
        new = arrays[n]
        if tuple(np.shape(new)) != tuple(old.shape):
            raise RolloutAborted(
                "checkpoint step %d leaf %s has shape %r, the "
                "serving model expects %r" % (int(step), n,
                                              tuple(np.shape(new)),
                                              tuple(old.shape)))
        new_leaves.append(_leaf_like(new, old))
    out = _tree_rebuild(like, iter(new_leaves))
    for dev in {t.device for t in new_leaves}:
        if dev.type == "cuda":
            # the copies ran on this thread's current stream: finish
            # them before another thread's engine reads the tensors
            torch.cuda.synchronize(dev)
    return out


class _Replica(object):
    """One engine replica: a thread that builds and exclusively owns a
    `ServingEngine`, pulls work from the fleet, steps, and reports
    completions. Identity (object + incarnation) IS the liveness lease
    the fleet fences on. Everything here is confined to the replica
    thread; the fleet reads only the immutable fields (name, index,
    incarnation, slo, and the composed `_engine_kw` — set once at
    construction, never mutated — for probe sizing)."""

    def __init__(self, fleet: "ServingFleet", index: int, incarnation: int,
                 slo: Optional[str], engine_kw: dict,
                 tier: Optional[str] = None, params=None,
                 weights_version: Optional[int] = None):
        self.index = index
        self.incarnation = incarnation
        self.slo = slo
        self.tier = tier
        # weight snapshot: the params + version this
        # incarnation serves, FIXED at construction — a rolling weight
        # swap never mutates a live replica, it replaces it (fresh
        # incarnation built against the fleet's new current weights),
        # so every token is attributable to exactly one version
        self.params = params
        self.weights_version = weights_version
        self.name = "r%d" % index
        self._fleet = fleet
        self._engine_kw = engine_kw
        self.engine: Optional[ServingEngine] = None  # guarded-by: replica
        self._serving: Dict[int, Any] = {}           # guarded-by: replica
        self._reported: Dict[int, int] = {}          # guarded-by: replica
        # batch-lane (zoo) jobs waiting their turn: at most ONE runs
        # per scheduler handshake, interleaved with engine steps
        self._batch_q: collections.deque = collections.deque()  # guarded-by: replica
        self._pool_rev = (0, 0)                      # guarded-by: replica
        self.thread = threading.Thread(
            target=self._loop, name="fleet-%s-i%d" % (self.name, incarnation),
            daemon=True)

    def start(self):
        self.thread.start()
        return self

    def _idle(self) -> bool:  # thread: replica
        e = self.engine
        return (not self._serving and not self._batch_q
                and e is not None
                and not e.live_slots and not e.queue_depth
                and not e.prefilling_slots)

    def _pool_summary(self):  # thread: replica
        """Rebuild the routing summary only when the pool changed (the
        trie is thread-confined here; the summary set handed to the
        fleet is immutable)."""
        pc = self.engine.prefix_cache
        if pc is None:
            return None
        rev = (pc.inserted_blocks, pc.evictions)
        if rev == self._pool_rev:
            return None
        self._pool_rev = rev
        return pc.summary()

    def _loop(self):  # thread: replica
        fleet = self._fleet
        hook = fleet._hook
        if hook is not None:
            hook.thread_started(
                "replica", "%s.i%d" % (self.name, self.incarnation))
        try:
            self._loop_body(fleet, hook)
        finally:
            if hook is not None:
                hook.thread_exiting()

    def _loop_body(self, fleet, hook):  # thread: replica
        try:
            params = self.params if self.params is not None \
                else fleet._params
            self.engine = fleet._engine_factory(
                params, fleet._cfg, replica_id=self.name,
                scheduler_hook=hook,
                weights_version=self.weights_version,
                **self._engine_kw)
            completed: List[Tuple[int, List[int], str, Optional[dict]]] = []
            progress: List[Tuple[int, List[int]]] = []
            while True:
                if hook is not None:
                    hook.yield_point("replica:%s:sync" % self.name)
                cmd, work, cancels, resync = fleet._sync(
                    self, completed, progress, idle=self._idle(),
                    summary=self._pool_summary(), stats=self._stats())
                completed = []
                progress = []
                if cmd == "stop":
                    return
                if resync:
                    # post-restore refresh: the fleet dropped this
                    # replica's routing summary at demotion but the
                    # pool (warm, unchanged) would never re-trigger
                    # the revision cache — invalidate it so the next
                    # handshake carries the full summary again
                    self._pool_rev = (-1, -1)
                for rid in cancels:
                    # work hedged away from this replica (demotion):
                    # stop spending steps on it; the journal fence
                    # already refuses anything it might still report
                    sh = self._serving.pop(rid, None)
                    if sh is not None:
                        self._reported.pop(rid, None)
                        self.engine.cancel(sh.rid)
                    if self._batch_q:
                        # a hedged-away batch job: drop our copy — the
                        # survivor re-runs the callable (idempotent
                        # zoo inference; the dedupe fence keeps one
                        # verdict even if both finish)
                        self._batch_q = collections.deque(
                            bh for bh in self._batch_q
                            if bh.rid != rid)
                for h in work:
                    if h.batch_fn is not None:
                        # batch-lane (zoo) job: runs between engine
                        # steps below, one per handshake
                        self._batch_q.append(h)
                        continue
                    try:
                        subkw = dict(
                            temperature=h.spec["temperature"],
                            eos_id=h.spec["eos_id"], seed=h.spec["seed"],
                            publish_len=h.spec["publish_len"],
                            deadline_at=h.deadline_at,
                            resume_tokens=h.resume or None)
                        if h.handoff_package is not None:
                            # durable-KV handoff: the block
                            # package the fleet fetched from the store
                            # at re-route — consumed once, here
                            subkw["handoff"] = h.handoff_package
                            h.handoff_package = None
                        if h.spec.get("adapter") is not None:
                            # keyword passed only when set: scripted
                            # engines without the adapter surface keep
                            # working (sched_explore.ScriptEngine)
                            subkw["adapter"] = h.spec["adapter"]
                        sh = self.engine.submit(
                            h.prompt, h.spec["max_new_tokens"], **subkw)
                    except ValueError as exc:
                        # a malformed request must fail ITSELF, not
                        # crash-loop the replica through failover
                        fleet._reject(h.rid, exc, rep=self)
                        continue
                    self._serving[h.rid] = sh
                    self._reported[h.rid] = 0
                if not self._idle():
                    if hook is not None:
                        hook.yield_point("replica:%s:step" % self.name)
                    self.engine.step()
                if self._batch_q:
                    # ONE zoo micro-batch per handshake, after the
                    # engine step: batch throughput rides the same
                    # scheduler cadence as prefill chunks do, so it
                    # can never starve the batched decode (the
                    # Sarathi interleave rule across workload kinds)
                    bh = self._batch_q.popleft()
                    if bh.deadline_at is not None \
                            and time.monotonic() >= bh.deadline_at:
                        # the deadline died waiting behind the engine:
                        # the expiry verdict, not a late 'done' — the
                        # every-queue-hop rule batch jobs get too
                        completed.append((bh.rid, [], "expired", None))
                    else:
                        try:
                            bh.batch_result = bh.batch_fn()
                        except Exception as exc:
                            # the JOB failed, not the replica: a
                            # terminal rejected verdict for this rid
                            # alone — fenced (rep=self), so a stale
                            # holder's local failure cannot reject a
                            # rid hedged to a healthy survivor
                            fleet._reject(bh.rid, exc, rep=self)
                        else:
                            completed.append((bh.rid, [], "done", None))
                for rid, sh in list(self._serving.items()):
                    # batched incremental progress: every token emitted
                    # since the last handshake rides ONE journal record
                    n = len(sh.tokens)
                    if n > self._reported[rid]:
                        progress.append(
                            (rid, list(sh.tokens[self._reported[rid]:n])))
                        self._reported[rid] = n
                    if sh.done:
                        reason = ("expired"
                                  if sh.finish_reason == "expired"
                                  else "done")
                        # handoff outcome side-band: what
                        # became of an imported block package — read
                        # via getattr so scripted engines without the
                        # surface keep working (_accept defaults the
                        # outcome for them when the assign shipped one)
                        outcome = getattr(sh, "handoff_outcome", None)
                        completed.append(
                            (rid, list(sh.tokens), reason, outcome))
                        del self._serving[rid]
                        del self._reported[rid]
        except Exception as exc:  # crash -> failover (incl. _KillDrill)
            if self.engine is not None:
                self.engine.abort(exc)
            self._fleet._on_crash(self, exc)

    def _stats(self) -> Optional[dict]:  # thread: replica
        e = self.engine
        if e is None:
            return None
        m = e.metrics
        out = {
            "tokens_out": m.tokens_out,
            "decode_steps": m.decode_steps,
            "prefills": m.prefills,
            "prefill_tokens_computed": m.prefill_tokens_computed,
            # block-pool / spec counters: the cumulative ones
            # fold into the fleet's _stats_base on replica death like
            # every other int here; kv_blocks_in_use is a GAUGE (a dead
            # replica's pool is gone), summed over LIVE snapshots only
            "kv_blocks_in_use": m.kv_blocks_in_use,
            "kv_blocks_freed_at_retire": m.kv_blocks_freed_at_retire,
            "kv_tail_blocks_freed": m.kv_tail_blocks_freed,
            "cow_blocks": m.cow_blocks,
            "spec_drafted": m.spec_drafted,
            "spec_accepted": m.spec_accepted,
            "expired": m.expired,
            "resumed_requests": m.resumed_requests,
            "resume_tokens_reused": m.resume_tokens_reused,
            # health-score inputs: step-latency EWMA is a
            # GAUGE (never folded into _stats_base); busy says whether
            # a progress watermark is even expected of this replica
            "step_ewma_s": m.step_ewma_s,
            "busy": bool(self._serving) or bool(e.live_slots)
            or bool(e.queue_depth) or bool(e.prefilling_slots),
            # construction gauges the fleet's per-replica rows surface:
            # which paged kernel this incarnation's steps attend with
            # (previously only read, never exported, so the
            # row was always None) and the storage dtypes
            # (getattr: scripted metric surfaces predate them)
            "paged_kernel": getattr(m, "paged_kernel", None),
            "kv_quant": getattr(m, "kv_quant", None),
            "weight_quant": getattr(m, "weight_quant", None),
        }
        if e.prefix_cache is not None:
            out["prefix_hits"] = e.prefix_cache.hits
            out["prefix_misses"] = e.prefix_cache.misses
            out["prefix_tokens_saved"] = e.prefix_cache.tokens_saved
        # getattr: scripted metric surfaces (sched_explore) predate it
        bf = getattr(m, "block_fp", None)
        if bf is not None:
            # fingerprint counters: cumulative ints, folded
            # into _stats_base on replica death/retire like the rest
            out["fp_committed"] = bf.committed
            out["fp_verified"] = bf.verified
            out["fp_mismatches"] = bf.mismatches
        if getattr(m, "kv_store", None) is not None:
            # durable-KV counters: cumulative ints, folded
            # into _stats_base on replica death/retire like the rest
            out["tokens_recomputed_at_migration"] = \
                m.tokens_recomputed_at_migration
            out["handoff_imports"] = m.handoff_imports
            out["handoff_blocks_imported"] = m.handoff_blocks_imported
            out["handoff_tokens_imported"] = m.handoff_tokens_imported
            out["handoff_fallbacks"] = m.handoff_fallbacks
            out["store_spilled_blocks"] = m.store_spilled_blocks
            out["store_warm_blocks"] = m.store_warm_blocks
            out["store_quarantined"] = m.store_quarantined
        ap = getattr(e.metrics, "adapter_pool", None)
        if ap is not None:
            # cumulative adapter-pool counters: fold into
            # _stats_base on replica death/retire like the rest
            out["adapter_hits"] = ap.hits
            out["adapter_misses"] = ap.misses
            out["adapter_evictions"] = ap.evictions
            out["adapter_uploads"] = ap.uploads
        return out


class ServingFleet(object):
    """Front door over N `ServingEngine` replica threads. Knobs:

      n_replicas           engine replicas (threads; one engine each)
      journal_path         durable request journal (None = in-memory
                           mirror only — failover still exact, but a
                           whole-process crash loses the table); an
                           existing file is replayed, so a restarted
                           front door resumes rids past its history
      journal_fsync        fsync every journal record (OS-crash
                           durability) instead of flush-only
                           (process-crash durability, the default —
                           fsync costs per-request disk latency)
      max_pending          fleet-wide bound on OPEN requests; past it
                           submit() raises FleetSaturated (load-shed)
      heartbeat_timeout_s  replica declared dead after this long
                           without a scheduler-loop heartbeat; size it
                           a few times the worst single engine step
                           (first-compile included!) or a busy replica
                           reads as dead (README sizing rule)
      affinity             prefix-affinity routing on/off (off =
                           least-loaded only)
      replica_slo          per-replica SLO class name list
                           ("interactive"/"batch"; None entry = serves
                           any class); default: all wildcard
      slo_classes          class -> engine-kw overrides (default maps
                           interactive/batch onto max_prefills_per_step
                           1/None)
      engine_kw            base kwargs for every replica engine
                           (max_slots, prefill_chunk_tokens,
                           prefix_cache_tokens, ...)
      engine_kw_for        optional fn(index) -> extra kwargs for one
                           replica (drills inject per-replica
                           FaultInjectors through this)
      auto_refill          monitor replaces DEAD replicas with a fresh
                           incarnation automatically (default False:
                           drills and operators call refill())
      journal_compact_every
                           rewrite the journal file down to its open
                           set once it holds this many records
                           (default 4096; None = never). Per-token
                           progress records make an append-only
                           journal grow with TRAFFIC, not in-flight
                           work — without compaction a long-lived
                           fleet fills the disk at decode rate
      slow_replica_factor  GRAY-failure detection: a BUSY
                           replica whose step-latency EWMA exceeds
                           this multiple of the live-fleet median is
                           slow; sustained past slow_min_duration_s it
                           is DEMOTED — drained of work (hedged to
                           survivors with token-level resume), kept
                           warm, probed, and restored when healthy.
                           None (default) disables detection: enable
                           it only on a WARMED fleet, or set
                           slow_min_duration_s above the first-compile
                           latency (README sizing rule) — a replica
                           compiling its first buckets is slow for
                           honest reasons
      slow_min_duration_s  hysteresis: the slow condition must hold
                           continuously this long before demotion (one
                           GC pause must not flap a healthy replica)
      probe_interval_s     cadence of health probes (tiny internal
                           generate requests) sent to a DEMOTED
                           replica; a probe completed with a healthy
                           step EWMA restores it — same incarnation,
                           warm engine and prefix pool
      probe_ok_needed      consecutive healthy probes required to
                           restore (restore-side hysteresis)
      replica_tier         per-SLOT disaggregation tier list
                           ("prefill"/"decode"/None; length
                           max_replicas). Fresh admissions route to
                           prefill-tier replicas and MIGRATE to a
                           decode-tier replica at first token via the
                           journaled resume path; None
                           entries serve both phases. Default: no
                           tiers (every replica does both)
      tier_classes         tier -> engine-kw overrides (default maps
                           prefill/decode onto max_prefills_per_step
                           None/1)
      min_replicas /       autoscaler bounds: the fleet
      max_replicas         holds max_replicas SLOTS; slots beyond
                           n_replicas start RETIRED (capacity held
                           back). Defaults: both = n_replicas (scaling
                           off). The scaler never retires below
                           min_replicas live replicas
      scale_up_open_per_replica
                           spawn a replica when open requests exceed
                           this many per live replica (queue-depth
                           pressure)
      scale_up_headroom_s  also spawn when any open request's deadline
                           headroom drops below this while requests
                           outnumber live replicas (None = off);
                           clamped up to one decode-window's wall time
                           on a decode_window=K fleet
                           (deadlines enforce at window granularity)
      scale_down_idle_s    retire a replica only after low load (open
                           requests < live replicas) holds this long
                           (sustained-idle hysteresis)
      scale_cooldown_s     ONE cool-down gate for both directions: at
                           most one scale operation per window, so a
                           burst cannot flap the fleet
      ckpt_dir             weight-PUBLISH dir `roll_weights()` reads
                           candidate weight sets from: step dirs
                           written by `save_weights(params, dir,
                           step)` (NOT a raw training save_checkpoint
                           scope — its entry names differ and the
                           load refuses them loudly). The training
                           side publishes here next to its own
                           checkpoints; a `sentinel.json` in this dir
                           (written or copied from the training run)
                           gives no-argument roll_weights() its
                           known-good default. None = rollout only
                           via explicit params=
      rollout_policy       what happens to in-flight requests when
                           their replica is swapped: "finish" (default
                           — the drain waits; tokens never mix
                           versions) or "migrate" (hedged to survivors
                           from the journal with token-level resume —
                           faster swap; the completion records the
                           final holder's version)
      weights_version      version tag of the CONSTRUCTION params
                           (default 0); roll_weights bumps it to the
                           checkpoint step it rolled to
      tenants              a `tenancy.TenantRegistry` turns on the
                           multi-tenant front door:
                           submit(tenant=) becomes required, each
                           submit is charged against the tenant's
                           token bucket (TenantQuotaExceeded — never
                           journaled, checked before FleetSaturated),
                           routing goes through a weighted fair queue
                           (one tenant's burst cannot starve
                           another's share), assign/done journal
                           records carry the typed tenant side-band,
                           and submit_batch() admits model-zoo jobs
                           into the same scheduler
      wfq_window           dispatch-window cap for the fair queue:
                           at most this many requests sit in replica
                           inboxes/engines at once, the rest wait in
                           WFQ order (None = live replicas x the
                           engine's max_slots). Smaller = fairer
                           under contention, larger = deeper engine
                           queues
      canary_interval_s    known-answer canary cadence:
                           every LIVE replica gets a tiny greedy
                           canary request on this period, judged
                           against a GOLDEN trace computed once per
                           weights_version (construction + every
                           roll_weights commit); a mismatch is an
                           integrity trip — quarantine + taint-aware
                           resume, exactly-once per incarnation. A
                           clean canary advances the replica's TAINT
                           BASE: a later trip taints (and re-decodes)
                           only tokens journaled past it. None
                           (default) = canaries off
      canary_max_new       golden-trace length in tokens (default 4);
                           see the README cadence-vs-step-latency
                           sizing rule
      canary_prompt /      explicit canary prompt / golden tokens —
      canary_golden        golden is REQUIRED for scripted engine
                           factories and quantized fleets (their
                           outputs are not token-identical to
                           generate(), so the fleet refuses to derive
                           the known answer itself)
      kv_store /           durable KV tier: pass a
      kv_store_dir /       KVBlockStore, or set kv_store_dir (spill
      kv_store_bytes       directory; store.jsonl under it) and/or
                           kv_store_bytes (host-RAM byte budget,
                           leaf-first eviction) and the fleet builds
                           ONE store shared by every replica: closed
                           blocks spill write-through at publish,
                           restarted/autoscaled replicas warm their
                           tries from it, and the router credits what
                           a replica can cheaply RESTORE, not just
                           what is resident. Default: no store (the
                           store-less fleet exactly)
      handoff              ship finished-prefix block packages at
                           migration/failover re-routes (default True;
                           needs a store). The clean path re-prefills
                           ZERO closed-block tokens; mismatch/absence
                           falls back to re-prefill, counted, never
                           wrong
    """

    def __init__(self, params, cfg, n_replicas=2, journal_path=None,
                 journal_fsync=False, max_pending=64,
                 heartbeat_timeout_s=30.0, monitor_interval_s=None,
                 affinity=True, replica_slo=None, slo_classes=None,
                 engine_kw=None, engine_kw_for=None, auto_refill=False,
                 journal_compact_every=4096, slow_replica_factor=None,
                 slow_min_duration_s=0.5, probe_interval_s=0.25,
                 probe_ok_needed=1, scheduler_hook=None,
                 engine_factory=None, replica_tier=None,
                 tier_classes=None, min_replicas=None, max_replicas=None,
                 scale_up_open_per_replica=4, scale_up_headroom_s=None,
                 scale_down_idle_s=2.0, scale_cooldown_s=1.0,
                 ckpt_dir=None, rollout_policy="finish",
                 weights_version=0, tenants=None, wfq_window=None,
                 canary_interval_s=None, canary_max_new=4,
                 canary_prompt=None, canary_golden=None,
                 kv_store=None, kv_store_dir=None, kv_store_bytes=None,
                 handoff=True):
        if int(n_replicas) < 1:
            raise ValueError("n_replicas must be >= 1")
        if int(max_pending) < 1:
            raise ValueError("max_pending must be >= 1")
        self._params = params  # guarded-by: _cond (swapped by rollout)
        self._cfg = cfg
        # deterministic-exploration seam: the hook is called
        # at every thread-handoff point (SchedulerHook contract above);
        # engine_factory lets the explorer substitute a host-only
        # scripted engine so interleavings, not compiles, dominate
        self._hook: Optional[SchedulerHook] = scheduler_hook
        self._engine_factory = (engine_factory if engine_factory
                                is not None else ServingEngine)
        # the port's engines run on the card unless engine_kw names the
        # CPU: resolved here, so a fleet with no card raises in the
        # caller instead of crash-looping in its replica threads
        self.device = (resolve_device((engine_kw or {}).get("device"))
                       if self._engine_factory is ServingEngine else None)
        if "prefix_block_tokens" in (engine_kw or {}):
            raise ValueError(
                "the port's engine takes kv_block_tokens (the reference's "
                "older prefix_block_tokens alias is not taken)")
        self.n_replicas = int(n_replicas)
        # elastic bounds: the fleet owns max_replicas SLOTS;
        # n_replicas of them start live, the rest start RETIRED. All
        # per-slot lists below are sized max_replicas once — the
        # autoscaler changes STATES, never list lengths
        self.min_replicas = (self.n_replicas if min_replicas is None
                             else int(min_replicas))
        self.max_replicas = (self.n_replicas if max_replicas is None
                             else int(max_replicas))
        if not (1 <= self.min_replicas <= self.n_replicas
                <= self.max_replicas):
            raise ValueError(
                "need 1 <= min_replicas (%d) <= n_replicas (%d) <= "
                "max_replicas (%d)" % (self.min_replicas,
                                       self.n_replicas,
                                       self.max_replicas))
        self.scale_up_open_per_replica = int(scale_up_open_per_replica)
        if self.scale_up_open_per_replica < 1:
            raise ValueError("scale_up_open_per_replica must be >= 1")
        self.scale_up_headroom_s = (
            None if scale_up_headroom_s is None
            else float(scale_up_headroom_s))
        self.scale_down_idle_s = float(scale_down_idle_s)
        self.scale_cooldown_s = float(scale_cooldown_s)
        if rollout_policy not in ("finish", "migrate"):
            raise ValueError(
                "rollout_policy must be 'finish' or 'migrate', got %r"
                % (rollout_policy,))
        self.rollout_policy = rollout_policy
        self.ckpt_dir = ckpt_dir
        self.max_pending = int(max_pending)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.affinity = bool(affinity)
        self.auto_refill = bool(auto_refill)
        if slow_replica_factor is not None \
                and float(slow_replica_factor) <= 1.0:
            raise ValueError("slow_replica_factor must be > 1 or None")
        self.slow_replica_factor = (
            None if slow_replica_factor is None
            else float(slow_replica_factor))
        self.slow_min_duration_s = float(slow_min_duration_s)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_ok_needed = int(probe_ok_needed)
        self.slo_classes = dict(_DEFAULT_SLO_CLASSES)
        if slo_classes:
            self.slo_classes.update(slo_classes)
        if replica_slo is not None \
                and len(replica_slo) != self.max_replicas:
            raise ValueError(
                "replica_slo must name a class per SLOT "
                "(max_replicas=%d)" % self.max_replicas)
        self._replica_slo = list(replica_slo
                                 or [None] * self.max_replicas)
        for c in self._replica_slo:
            if c is not None and c not in self.slo_classes:
                raise ValueError("unknown SLO class %r" % c)
        self.tier_classes = dict(_DEFAULT_TIER_CLASSES)
        if tier_classes:
            self.tier_classes.update(tier_classes)
        if replica_tier is not None \
                and len(replica_tier) != self.max_replicas:
            raise ValueError(
                "replica_tier must name a tier per SLOT "
                "(max_replicas=%d)" % self.max_replicas)
        self._replica_tier = list(replica_tier
                                  or [None] * self.max_replicas)
        for t in self._replica_tier:
            if t is not None and t not in self.tier_classes:
                raise ValueError("unknown tier %r" % t)
        # migration only makes sense when both phases have a home
        self._tiered = any(t is not None for t in self._replica_tier)
        self._engine_kw = dict(engine_kw or {})
        self._engine_kw_for = engine_kw_for
        # ONE block granularity: the engine's paged KV pool and the
        # prefix trie share it (kv_block_tokens).
        # `is None` defaulting, like the engine: an explicit invalid 0
        # must raise HERE, not as a replica-thread crash loop later
        # block_tokens/_pool_blocks are the BASE-kw limits, used for
        # the submit() precheck: a request whose worst case exceeds a
        # WHOLE replica pool can never be admitted anywhere — fail in
        # the caller (the engine's own rule; a merely saturated pool
        # queues instead)
        _, self.block_tokens, self._pool_blocks = self._limits_for(
            self._engine_kw)
        # durable KV tier: ONE store shared by every
        # replica (it carries its own lock — the RequestJournal
        # discipline), constructed only when explicitly requested so
        # the default fleet is byte-identical to the store-less one.
        # Injected into the engine base kw: every replica spills its
        # closing blocks write-through and warms its trie from the
        # store at spawn (restart, failover incarnation, autoscale).
        self.handoff = bool(handoff)
        self._kv_store_owned = False
        if kv_store is None and (kv_store_dir is not None
                                 or kv_store_bytes is not None):
            kv_store = KVBlockStore(
                byte_budget=kv_store_bytes, dir=kv_store_dir,
                block_tokens=self.block_tokens,
                fault_injector=self._engine_kw.get("fault_injector"))
            self._kv_store_owned = True
        self.kv_store = kv_store
        if kv_store is not None:
            if int(kv_store.block_tokens) != int(self.block_tokens):
                raise ValueError(
                    "kv_store block_tokens (%d) != fleet block "
                    "granularity (%d) — one store, one geometry"
                    % (int(kv_store.block_tokens),
                       int(self.block_tokens)))
            if not self._engine_kw.get("prefix_cache_tokens"):
                raise ValueError(
                    "kv_store needs the prefix cache (set "
                    "prefix_cache_tokens in engine_kw): blocks spill "
                    "at trie publish and warm-start restores into "
                    "the trie")
            self._engine_kw["kv_store"] = kv_store
            self._engine_kw["kv_store_warm"] = True
        # ONE storage dtype: failover, token-level resume,
        # and prefix-summary affinity all assume every replica decodes
        # the same numerics — a request hedged from an int8 replica to
        # an f32 one would change models mid-sequence. The base kw's
        # quant settings are the fleet's; per-replica overrides that
        # differ are refused at spawn (_make_replica), like the block
        # granularity under affinity but unconditionally.
        self.kv_quant = str(self._engine_kw.get("kv_quant") or "none")
        self.weight_quant = self._engine_kw.get("weight_quant")
        # chain keys only pay off when there is a pool to match: with
        # no base prefix_cache_tokens every summary stays empty, so
        # skip the per-submit O(T0) crc work entirely
        self._chain_prompts = bool(affinity) and bool(
            self._engine_kw.get("prefix_cache_tokens"))
        # multi-tenant front door: a TenantRegistry turns
        # on (a) token-bucket quota admission — a submit past the
        # tenant's bucket raises TenantQuotaExceeded, never journaled,
        # like FleetSaturated — and (b) weighted fair queueing: when
        # every replica's dispatch window is full, requests wait in a
        # per-fleet WFQ and drain in virtual-finish-tag order at every
        # scheduler handshake, so one tenant's burst cannot starve
        # another's share. `wfq_window` caps requests dispatched into
        # replica inboxes/engines at once (None = live replicas x the
        # engine's max_slots — enough to keep every slot fed while the
        # excess queues fairly at the front door).
        self._tenants = tenants
        self._wfq: Optional[WFQueue] = (
            WFQueue() if tenants is not None else None)
        if wfq_window is not None and int(wfq_window) < 1:
            raise ValueError("wfq_window must be >= 1 or None")
        self._wfq_window = (None if wfq_window is None
                            else int(wfq_window))
        self._slots_per_replica = int(
            self._engine_kw.get("max_slots") or 8)
        # known-answer canaries: periodic canary requests on
        # LIVE replicas (the probe machinery, extended past
        # demoted-only), judged against a GOLDEN token trace computed
        # once per weights_version. A mismatch is an integrity trip:
        # quarantine + taint-aware resume, not demotion.
        self.canary_interval_s = (None if canary_interval_s is None
                                  else float(canary_interval_s))
        self.canary_max_new = int(canary_max_new)
        self._canary_prompt = tuple(
            int(t) for t in (canary_prompt if canary_prompt is not None
                             else CANARY_PROMPT))
        self._canary_golden: Dict[Any, List[int]] = {}  # guarded-by: _cond
        self._canary_golden_default: Optional[List[int]] = None
        self._canary_auto = False
        if self.canary_interval_s is not None:
            if self.canary_interval_s <= 0.0:
                raise ValueError("canary_interval_s must be > 0 or None")
            if self.canary_max_new < 1:
                raise ValueError("canary_max_new must be >= 1")
            if canary_golden is not None:
                # explicit golden: scripted engines (sched_explore) and
                # quantized fleets supply their own known answer
                self._canary_golden_default = [int(t)
                                               for t in canary_golden]
            else:
                if self._engine_factory is not ServingEngine:
                    raise ValueError(
                        "canaries on a custom engine_factory need an "
                        "explicit canary_golden= (the fleet cannot "
                        "derive a golden trace for a scripted engine)")
                if self.kv_quant != "none" or self.weight_quant is not None:
                    raise ValueError(
                        "canaries on a quantized fleet need an explicit "
                        "canary_golden=: quantized engine outputs are "
                        "not token-identical to generate(), so the "
                        "fleet cannot compute the golden trace itself")
                self._canary_auto = True
                self._canary_golden[int(weights_version)] = golden_trace(
                    params, cfg, self._canary_prompt,
                    self.canary_max_new)

        # ONE lock for all fleet scheduler state (the condition owns
        # it); replica + monitor threads mutate ONLY under it
        self._cond = threading.Condition()
        # serializes _flush_journal's swap+write as one unit (always
        # acquired BEFORE _cond, never while holding it): without it
        # two flushers could write their batches to the FILE in the
        # opposite order they were swapped, and per-rid progress
        # records would land inverted on disk — a restart would
        # recover a scrambled resume prefix
        self._flush_lock = threading.Lock()
        self._journal = RequestJournal(journal_path, fsync=journal_fsync,
                                       compact_every=journal_compact_every)
        self._replicas: List[_Replica] = []            # guarded-by: _cond
        self._state: List[str] = []                    # guarded-by: _cond
        self._beats: List[float] = []                  # guarded-by: _cond
        self._kill: List[bool] = []                    # guarded-by: _cond
        self._inbox: List[collections.deque] = []      # guarded-by: _cond
        self._in_flight: List[Dict[int, FleetHandle]] = []  # guarded-by: _cond
        self._summaries: List[Set[int]] = []           # guarded-by: _cond
        self._rep_stats: List[Optional[dict]] = []     # guarded-by: _cond
        # dead incarnations' last stats snapshots fold in here so
        # fleet totals stay monotonic across failover/refill
        self._stats_base: Dict[str, int] = {}          # guarded-by: _cond
        self._spawned: List[float] = []                # guarded-by: _cond
        self._rapid: List[int] = []                    # guarded-by: _cond
        self._refill_at: List[float] = []              # guarded-by: _cond
        self._incarnations: List[int] = []             # guarded-by: _cond
        # gray-failure health tracking: when the slow
        # condition first held (None = healthy), per-replica progress
        # watermark samples (monotonic t, tokens_out), pending cancels
        # (work hedged away a demoted replica must stop), outstanding
        # probe handle + schedule + consecutive-good count
        self._slow_since: List[Optional[float]] = []   # guarded-by: _cond
        self._watermark: List[Optional[Tuple[float, int]]] = []  # guarded-by: _cond
        self._rate: List[Optional[float]] = []         # guarded-by: _cond
        self._stall_since: List[Optional[float]] = []  # guarded-by: _cond
        self._cancels: List[Set[int]] = []             # guarded-by: _cond
        self._probes: List[Optional[FleetHandle]] = []  # guarded-by: _cond
        self._probe_at: List[float] = []               # guarded-by: _cond
        self._probe_ok: List[int] = []                 # guarded-by: _cond
        # restore-time summary refresh: demotion cleared the routing
        # summary, and the replica's revision cache would otherwise
        # never resend an UNCHANGED (warm!) pool after restore
        self._want_summary: List[bool] = []            # guarded-by: _cond
        # serving integrity: outstanding canary handle +
        # schedule per slot, the TAINT BASE — per in-flight rid, the
        # resume length at ASSIGNMENT (tokens earlier holders already
        # vouched for) — and the CANARY MARK, the journaled-progress
        # length the last clean canary vouched for. A trip taints
        # [start, now) where start is the canary mark ONLY for
        # canary-kind trips: a canary exercises the engine-global
        # compute path (the garble class), so its clean verdict can
        # vouch for every token the engine emitted — but it never
        # attends through another request's KV blocks, so a
        # fingerprint/trap/spike trip (block-level corruption the
        # canary cannot see) must taint from the assignment base
        self._canaries: List[Optional[FleetHandle]] = []  # guarded-by: _cond
        self._canary_at: List[float] = []              # guarded-by: _cond
        self._taint_base: List[Dict[int, int]] = []    # guarded-by: _cond
        self._canary_mark: List[Dict[int, int]] = []   # guarded-by: _cond
        # elastic lifecycle: drain-then-retire marker the
        # scaler sets and the replica's own handshake consumes, plus
        # the scaler's shared cool-down gate and sustained-low-load
        # clock, and the rollout mutual-exclusion latch
        self._retire_flag: List[bool] = []             # guarded-by: _cond
        self._scale_gate_at = 0.0                      # guarded-by: _cond
        self._low_load_since: Optional[float] = None   # guarded-by: _cond
        self._rollout = False                          # guarded-by: _cond
        self._weights_version = int(weights_version)   # guarded-by: _cond
        self._next_probe_rid = -1                      # guarded-by: _cond
        self._handles: Dict[int, FleetHandle] = {}     # guarded-by: _cond
        self._open: Set[int] = set()                   # guarded-by: _cond
        self._done_rids: Set[int] = set()              # guarded-by: _cond
        # client-cancelled rids: subset of _done_rids, so a
        # holder's late completion for an abandoned request is counted
        # as the CANCEL's expected tail, not a duplicate answer — the
        # kill-drill duplicates==0 bar stays meaningful under
        # disconnect storms
        self._cancelled_rids: Set[int] = set()         # guarded-by: _cond
        # journal FILE records produced under the lock (mirror updates
        # are synchronous); flushed by _flush_journal() after release
        # so disk latency never stalls handshakes or the monitor.
        # Completion events fire AFTER the flush: a caller observing a
        # result implies its done record is already written
        self._pending_journal: List[dict] = []         # guarded-by: _cond
        self._pending_events: List[FleetHandle] = []   # guarded-by: _cond
        # stream deliveries produced under the lock: each
        # entry is (handle, tokens, closing) — fed to the handle's
        # stream buffer by _flush_journal AFTER the records describing
        # those tokens are on disk, the same read-your-writes ordering
        # completion events get
        self._pending_stream: List[
            Tuple[FleetHandle, List[int], bool]] = []  # guarded-by: _cond
        # continue past an existing journal's history: a restarted
        # front door appending to the same file must never reuse a rid
        self._next_rid = self._journal.next_rid()      # guarded-by: _cond
        self._closing = False                          # guarded-by: _cond
        # O(1) counters (the ServingMetrics discipline)
        self.submitted = 0                             # guarded-by: _cond
        self.completed = 0                             # guarded-by: _cond
        self.shed = 0                                  # guarded-by: _cond
        self.rejected = 0                              # guarded-by: _cond
        self.expired = 0                               # guarded-by: _cond
        # deadline dead on arrival: shed-like (never journaled, never
        # counted as submitted) but kept APART from `shed` so overload
        # and client-side lateness stay distinguishable
        self.expired_on_arrival = 0                    # guarded-by: _cond
        # per-tenant quota shed: like `shed`, never
        # journaled — but scoped to one tenant's bucket, so overload
        # (FleetSaturated) and quota enforcement stay distinguishable
        self.quota_shed = 0                            # guarded-by: _cond
        self.batch_jobs_completed = 0                  # guarded-by: _cond
        # client cancels: terminal verdicts the SUBMITTER
        # asked for (disconnect / cancel frame) — kept apart from
        # every fleet-side verdict so stats()['lost'] stays exact; a
        # holder's late completion for a cancelled rid increments
        # cancel_late_refused, never duplicate_refused
        self.cancelled = 0                             # guarded-by: _cond
        self.cancel_late_refused = 0                   # guarded-by: _cond
        self.resubmitted = 0                           # guarded-by: _cond
        self.failovers = 0                             # guarded-by: _cond
        self.zombie_refused = 0                        # guarded-by: _cond
        self.duplicate_refused = 0                     # guarded-by: _cond
        self.demotions = 0                             # guarded-by: _cond
        self.restores = 0                              # guarded-by: _cond
        self.probes_sent = 0                           # guarded-by: _cond
        self.resumed_requests = 0                      # guarded-by: _cond
        self.resumed_tokens = 0                        # guarded-by: _cond
        # elastic lifecycle counters: fleet-scope
        # monotonic ints — they survive any replica's retirement by
        # construction, unlike per-replica stats (which fold into
        # _stats_base when an incarnation ends)
        self.replicas_spawned = 0                      # guarded-by: _cond
        self.replicas_retired = 0                      # guarded-by: _cond
        self.migrations = 0                            # guarded-by: _cond
        self.rollouts_completed = 0                    # guarded-by: _cond
        self.rollout_aborts = 0                        # guarded-by: _cond
        # serving-integrity counters: fleet-scope monotonic
        self.integrity_trips = 0                       # guarded-by: _cond
        # trip KIND attribution ("trap"/"fingerprint"/"spike"/"canary")
        self.integrity_trip_kinds: Dict[str, int] = {}  # guarded-by: _cond
        self.canaries_sent = 0                         # guarded-by: _cond
        self.canaries_ok = 0                           # guarded-by: _cond
        self.canary_mismatches = 0                     # guarded-by: _cond
        self.tainted_tokens = 0                        # guarded-by: _cond
        # durable-KV counters: fleet-scope monotonic.
        # handoff_packages = block packages attached at re-route;
        # handoff_fallbacks_defaulted = dones whose holder never
        # reported an import outcome (scripted engines) — the fleet
        # stamps the honest {"imported": 0, "fallback": True} so the
        # J011 fence still closes
        self.handoff_packages = 0                      # guarded-by: _cond
        self.handoff_fallbacks_defaulted = 0           # guarded-by: _cond

        self._idle_wait_s = min(0.02, self.heartbeat_timeout_s / 10.0)
        self._monitor_interval_s = (
            monitor_interval_s if monitor_interval_s is not None
            else max(0.01, min(0.2, self.heartbeat_timeout_s / 5.0)))
        with self._cond:
            for i in range(self.max_replicas):
                self._incarnations.append(1)
                # slots past n_replicas are held-back capacity: they
                # start RETIRED (no thread) until scale-up or refill()
                self._state.append(_LIVE if i < self.n_replicas
                                   else _RETIRED)
                self._beats.append(time.monotonic())
                self._kill.append(False)
                self._inbox.append(collections.deque())
                self._in_flight.append({})
                self._summaries.append(set())
                self._rep_stats.append(None)
                self._spawned.append(time.monotonic())
                self._rapid.append(0)
                self._refill_at.append(0.0)
                self._slow_since.append(None)
                self._watermark.append(None)
                self._rate.append(None)
                self._stall_since.append(None)
                self._cancels.append(set())
                self._probes.append(None)
                self._probe_at.append(0.0)
                self._probe_ok.append(0)
                self._want_summary.append(False)
                self._retire_flag.append(False)
                self._canaries.append(None)
                self._canary_at.append(
                    time.monotonic() + (self.canary_interval_s or 0.0))
                self._taint_base.append({})
                self._canary_mark.append({})
                self._replicas.append(self._make_replica(i, 1))
        for i, r in enumerate(self._replicas):
            if self._state[i] == _LIVE:
                r.start()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="fleet-monitor", daemon=True)
        self._monitor.start()

    # -- construction helpers -------------------------------------------
    def _limits_for(self, kw: dict):
        """Structural admission limits — (max context, block tokens,
        pool blocks) — for one set of composed engine kwargs. The ONE
        derivation of the engine's `is None` defaulting rules: the
        constructor applies it to the base kw for the submit()
        precheck, probe sizing applies it to a replica's PER-REPLICA
        composed kw (an engine_kw_for override with a smaller
        context/pool must shrink the probe too, or that replica fails
        every probe at admission and stays demoted forever)."""
        bt = kw.get("kv_block_tokens")
        bt = 16 if bt is None else int(bt)
        if bt < 1:
            raise ValueError("kv_block_tokens must be >= 1")
        L = min(int(kw.get("max_len") or self._cfg.max_len),
                int(self._params["pos"].shape[0]))
        pb = kw.get("kv_pool_blocks")
        pb = (int(kw.get("max_slots", 8)) * (-(-L // bt))
              if pb is None else int(pb))
        if pb < 1:
            raise ValueError("kv_pool_blocks must be >= 1")
        return L, bt, pb

    def _make_replica(self, index: int, incarnation: int) -> _Replica:
        kw = dict(self._engine_kw)
        slo = self._replica_slo[index]
        if slo is not None:
            kw.update(self.slo_classes[slo])
        tier = self._replica_tier[index]
        if tier is not None:
            # tier overrides win over the SLO class: disaggregation is
            # a structural role, SLO a per-request preference
            kw.update(self.tier_classes[tier])
        if self._engine_kw_for is not None:
            kw.update(self._engine_kw_for(index) or {})
        rep_bt = kw.get("kv_block_tokens")
        rep_bt = self.block_tokens if rep_bt is None else int(rep_bt)
        if self.affinity and rep_bt != self.block_tokens:
            # chain keys are computed at the FLEET's block size; a
            # replica caching at a different granularity would never
            # match them and affinity would silently degrade to
            # least-loaded — refuse loudly instead
            raise ValueError(
                "affinity routing requires a uniform block granularity "
                "across replicas (fleet %d, replica %d override %r)"
                % (self.block_tokens, index, rep_bt))
        # mixed-quant fleet: refused loudly. Unlike the
        # block-size rule this is unconditional — failover/resume move
        # requests between replicas, and a replica decoding different
        # numerics would silently change a request's model mid-stream
        rep_kvq = str(kw.get("kv_quant") or "none")
        if rep_kvq != self.kv_quant:
            raise ValueError(
                "mixed-quant fleet refused: fleet kv_quant=%r, replica "
                "%d override %r — every replica must store KV in one "
                "dtype (failover/resume move requests between them)"
                % (self.kv_quant, index, rep_kvq))
        rep_wq = kw.get("weight_quant")
        if rep_wq != self.weight_quant:
            raise ValueError(
                "mixed-quant fleet refused: fleet weight_quant=%r, "
                "replica %d override %r"
                % (self.weight_quant, index, rep_wq))
        return _Replica(self, index, incarnation, slo, kw, tier=tier,
                        params=self._params,
                        weights_version=self._weights_version)

    # -- admission -------------------------------------------------------
    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_id=None, seed=0, publish_len=None,
               slo=_SLO_UNSET, deadline_s=None,
               resume_tokens=None, tenant=None,
               adapter=None, stream=False,
               conn=None) -> FleetHandle:
        """Journal the request durably, then route it (prefix affinity
        within the SLO class). Raises `FleetSaturated` when
        `max_pending` requests are already open — the shed request is
        NOT journaled, so backpressure never grows the durable table
        either. `deadline_s` is the request's end-to-end latency
        budget: journaled with the spec, enforced at every queue hop
        (admission, routing, prefill chunk, decode), and terminally
        `expired` — a verdict, never a silent hang — the moment it
        cannot be met. A deadline already spent on arrival raises
        `DeadlineExceeded` BEFORE the saturation check (and journals
        nothing), so shed metrics never conflate overload with
        client-side lateness. `resume_tokens` is the FRONT-DOOR
        RESTART half of token-level resume: tokens a previous fleet
        process already emitted for this request (from
        `RequestJournal.recover_progress`); they count against
        `max_new_tokens`, are journaled as a progress record before
        routing (durable across a second crash), prefill-aliased by
        the assignee, and never re-decoded — a prefix that already
        reached its budget or `eos_id` completes straight from the
        journal with zero engine work.

        Multi-tenant fleets (`tenants=` set): `tenant` is
        REQUIRED and must be registered; the submit is charged against
        the tenant's token bucket FIRST (a spent bucket raises
        `TenantQuotaExceeded` — never journaled, and checked before
        the `FleetSaturated` shed so one tenant's burst is shed as ITS
        quota verdict, not fleet overload), `adapter` defaults to the
        tenant's registered LoRA adapter (engines need
        `adapter_registry` in `engine_kw`), routing goes through the
        weighted fair queue (dispatch may defer — a no-live-replica
        failure then lands on the handle instead of raising here),
        and the journal's assign/done records carry the typed
        `tenant` side-band.

        `stream=True` arms incremental delivery: the
        handle's `stream()`/`stream_chunks()` iterators yield tokens
        as the journal's batched flushes land them, concatenating
        bit-identically to `result()` across failover/migration.
        `conn` names the wire connection the request arrived on; both
        ride the journal's submit record as the typed wire side-band
        and surface in FleetTimeout's describe context."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.shape[0] < 1:
            raise ValueError("empty prompt")
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        resume = None
        if resume_tokens is not None:
            resume = [int(t) for t in resume_tokens]
            if len(resume) > int(max_new_tokens):
                raise ValueError(
                    "resume_tokens longer than max_new_tokens "
                    "(%d > %d): the prefix cannot have come from this "
                    "request's budget" % (len(resume),
                                          int(max_new_tokens)))
            if not resume:
                resume = None
        # fail fast HERE with the engine's admission rule (including a
        # base engine_kw max_len override): a request that cannot fit
        # must error in the caller, not asynchronously at result()
        L = min(int(self._engine_kw.get("max_len") or self._cfg.max_len),
                int(self._params["pos"].shape[0]))
        if prompt.shape[0] + int(max_new_tokens) > L:
            raise ValueError(
                "request needs T0+max_new <= max_len (%d + %d > %d)"
                % (prompt.shape[0], int(max_new_tokens), L))
        need = -(-(prompt.shape[0] + int(max_new_tokens))
                 // self.block_tokens)
        if need > self._pool_blocks:
            raise ValueError(
                "request worst case (%d blocks) exceeds a whole replica "
                "KV pool (%d blocks of %d tokens)"
                % (need, self._pool_blocks, self.block_tokens))
        if publish_len is not None and publish_len < 0:
            raise ValueError("publish_len must be >= 0 or None")
        if self._tenants is not None:
            if tenant is None:
                raise ValueError(
                    "this fleet is multi-tenant: submit(tenant=...) "
                    "is required (registered: %r)"
                    % self._tenants.names())
            t = self._tenants.get(tenant)  # KeyError on unknown
            if adapter is None:
                adapter = t.adapter  # the tenant's default delta
            if slo is _SLO_UNSET:
                slo = t.slo  # the tenant's default class
        elif tenant is not None:
            raise ValueError(
                "tenant %r named but the fleet has no TenantRegistry "
                "(pass tenants=)" % (tenant,))
        if slo is _SLO_UNSET:
            slo = "interactive"
        if slo is not None and slo not in self.slo_classes:
            raise ValueError("unknown SLO class %r" % slo)
        if adapter is not None \
                and "adapter_registry" not in self._engine_kw:
            raise ValueError(
                "request names adapter %r but the engines have no "
                "adapter pool (put adapter_registry in engine_kw)"
                % (adapter,))
        deadline_at = None
        if deadline_s is not None:
            deadline_at = time.monotonic() + float(deadline_s)
        spec = {
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "temperature": float(temperature),
            "eos_id": None if eos_id is None else int(eos_id),
            "seed": int(seed),
            "publish_len": None if publish_len is None else int(publish_len),
            "slo": slo,
            # wall-clock pair: a recovered front door recomputes the
            # remaining budget as deadline_s - (now - submit_unix)
            "deadline_s": None if deadline_s is None else float(deadline_s),
            "submit_unix": time.time(),
            # multi-tenant side-band: the admitting tenant
            # and the LoRA adapter the engines apply (both None on a
            # single-tenant fleet)
            "tenant": tenant,
            "adapter": adapter,
        }
        with self._cond:
            if self._closing:
                raise RuntimeError("fleet is closed")
            if deadline_s is not None and float(deadline_s) <= 0.0:
                # the deadline died client-side BEFORE the fleet could
                # matter: an `expired` verdict, checked ahead of the
                # saturation shed so overload metrics stay honest —
                # and never journaled (like shed: the durable table
                # only holds requests the fleet accepted)
                self.expired_on_arrival += 1
                raise DeadlineExceeded(
                    "request arrived with its deadline already spent "
                    "(deadline_s=%r)" % deadline_s)
            h = self._admit_open_locked(tenant, prompt, spec, slo,
                                        deadline_at)
            rid = h.rid
            h.streaming = bool(stream)
            h.conn = None if conn is None else str(conn)
            # WFQ service estimate: the request's token footprint, so
            # a tenant's fair share is proportional to TOKENS of work,
            # not request count
            h.cost = float(prompt.shape[0] + int(max_new_tokens))
            if self._chain_prompts:  # keys feed ONLY affinity routing
                h.chain = chain_keys(prompt, self.block_tokens)
        # durable BEFORE routing — and OUTSIDE the fleet lock, so the
        # journal's write+flush never stalls replica handshakes or the
        # monitor behind disk latency
        self._journal.submit(rid, spec, conn=h.conn, stream=h.streaming)
        if resume is not None:
            # the restart prefix rides a progress record ahead of any
            # assignment: a second front-door crash recovers it exactly
            # like tokens journaled the normal way, and lost()/failover
            # concatenate later deltas after it
            self._journal.progress(rid, "__restart__", -1, 0, resume,
                                   conn=h.conn, stream=h.streaming)
        if self._hook is not None:
            # the close()-race window: the request is durably journaled
            # and open, but not yet routed — a concurrent close() must
            # leave it with exactly ONE terminal record
            self._hook.yield_point("submit:commit")
        try:
            with self._cond:
                if self._closing:
                    # close() raced the journal write: it already
                    # failed this handle (it was in _open). Terminal
                    # record, or the journaled rid stays open and
                    # every future recover() resubmits a request
                    # whose caller was told it failed
                    self._reject_locked(rid, "fleet closed")
                    raise RuntimeError("fleet is closed")
                if resume is not None:
                    if self._finished_in_journal(spec, resume):
                        self._complete_from_progress(
                            h, resume, "__restart__", -1)
                        return h
                    h.resume = list(resume)
                    h.emitted = len(resume)
                    # the restart prefix is already journaled: stream
                    # it ahead of the assignee's deltas so a resumed
                    # stream splices token-exactly (same order the
                    # journal mirror concatenates for failover)
                    self._stream_queue_locked(h, list(resume))
                    self.resumed_requests += 1
                    self.resumed_tokens += len(resume)
                if self._wfq is not None:
                    # multi-tenant routing goes through the weighted
                    # fair queue: dispatch now if a replica window is
                    # open, else wait in virtual-finish-tag order
                    self._wfq.push(h.tenant,
                                   self._tenants.get(h.tenant).weight,
                                   h.cost, h)
                    self._dispatch_locked()
                else:
                    self._route(h, exclude=None)
        finally:
            # also on the raises above: the terminal reject record
            # must be on disk before the caller sees the error
            self._flush_journal()
        return h

    def _admit_open_locked(self, tenant, prompt, spec, slo,
                           deadline_at) -> FleetHandle:
        """Shared admission core of submit()/submit_batch() (caller
        holds `_cond`): the ORDER-SENSITIVE quota invariant lives here
        ONCE — quota CHECKED before the fleet-wide saturation shed (a
        bursting tenant is refused on ITS quota, TenantQuotaExceeded,
        like FleetSaturated never journaled — overload metrics and
        per-tenant enforcement cannot blur), but CONSUMED only after
        it (a saturation-shed request must not drain the bucket or
        count as submitted) — then rid allocation and handle
        registration."""
        if self._closing:
            raise RuntimeError("fleet is closed")
        if self._tenants is not None and tenant is not None:
            try:
                self._tenants.check_quota(tenant)
            except TenantQuotaExceeded:
                self.quota_shed += 1
                raise
        if len(self._open) >= self.max_pending:
            self.shed += 1
            raise FleetSaturated(
                "fleet saturated: %d open requests (max_pending=%d)"
                % (len(self._open), self.max_pending))
        if self._tenants is not None and tenant is not None:
            self._tenants.consume(tenant)
        rid = self._next_rid
        self._next_rid += 1
        h = FleetHandle(rid, prompt, spec, slo, fleet=self,
                        deadline_at=deadline_at)
        h.tenant = tenant
        self._handles[rid] = h
        self._open.add(rid)
        self.submitted += 1
        return h

    def submit_batch(self, fn, tenant: str, cost: float = 1.0,
                     description: str = "batch", deadline_s=None,
                     slo=_SLO_UNSET) -> FleetHandle:
        """Admit one BATCH-LANE job: a host callable — e.g.
        one image/CTR model-zoo micro-batch through the existing
        `fluid.Executor` path (`tenancy.executor_batch_fn`) — that
        shares the continuous-batching scheduler with LM work. The job
        rides the SAME admission as every request: the tenant's quota
        bucket (TenantQuotaExceeded, never journaled), the weighted
        fair queue (`cost` is its service estimate in the same token
        currency as LM requests), the journal (assign/done with the
        typed tenant side-band; the spec records kind="batch" — a
        restarted front door recovers the rid but cannot rebuild the
        callable, so batch jobs recovered from a journal are for the
        CALLER to resubmit), and failover (a replica dying mid-lane
        resubmits the job to a survivor; a job hedged away from a
        demoted replica may execute twice — zoo inference is
        idempotent, the dedupe fence keeps exactly one verdict). A
        replica runs at most ONE batch job per scheduler handshake,
        interleaved with its engine's decode steps, so zoo throughput
        never starves decode latency. The result lands on
        `handle.batch_result`; `handle.result()` returns an empty
        token array once done."""
        if self._tenants is None:
            raise ValueError(
                "submit_batch needs a multi-tenant fleet (tenants=)")
        if not callable(fn):
            raise ValueError("submit_batch needs a callable job")
        t = self._tenants.get(tenant)
        if slo is _SLO_UNSET:
            # same sentinel as submit(): the tenant default applies
            # only when the caller said NOTHING — an explicit slo=None
            # stays the any-replica wildcard
            slo = t.slo
        if slo is not None and slo not in self.slo_classes:
            raise ValueError("unknown SLO class %r" % slo)
        deadline_at = None
        if deadline_s is not None:
            deadline_at = time.monotonic() + float(deadline_s)
        spec = {
            "kind": "batch", "description": str(description),
            "max_new_tokens": 0, "temperature": 0.0, "eos_id": None,
            "seed": 0, "publish_len": None, "slo": slo,
            "deadline_s": (None if deadline_s is None
                           else float(deadline_s)),
            "submit_unix": time.time(),
            "tenant": tenant, "adapter": None,
        }
        with self._cond:
            h = self._admit_open_locked(
                tenant, np.zeros(0, np.int32), spec, slo, deadline_at)
            rid = h.rid
            h.cost = float(cost)
            h.batch_fn = fn
        self._journal.submit(rid, spec)
        if self._hook is not None:
            self._hook.yield_point("submit:commit")
        try:
            with self._cond:
                if self._closing:
                    self._reject_locked(rid, "fleet closed")
                    raise RuntimeError("fleet is closed")
                self._wfq.push(tenant, t.weight, h.cost, h)
                self._dispatch_locked()
        finally:
            self._flush_journal()
        return h

    def cancel(self, rid: int) -> bool:
        """Client-side cancel: terminally close an open
        request because its SUBMITTER walked away — the front door
        calls this when a wire connection drops mid-stream or sends a
        cancel frame. Journals a `cancelled` terminal (the DFA accepts
        it as closed), fails the handle with `RequestCancelled`
        carrying the journaled token prefix, and claws the work back
        everywhere it might live: the WFQ/inbox copy is dropped before
        any replica spends a step on it, and an in-flight copy rides
        the SAME per-replica cancel set demotion hedging uses — the
        holder's next handshake calls `engine.cancel`, freeing the
        slot and every KV block the abandoned stream held. Idempotent;
        returns False once the rid is already terminal. A holder that
        finishes anyway loses to the `_cancelled_rids` fence in
        `_accept` (counted `cancel_late_refused`, never a
        duplicate)."""
        with self._cond:
            h = self._handles.get(rid)
            if h is None or h.done or rid in self._done_rids \
                    or h._probe or h._canary:
                return False
            toks = self._journal.progress_of(rid)
            self._done_rids.add(rid)
            self._cancelled_rids.add(rid)
            self._open.discard(rid)
            self._handles.pop(rid, None)
            for i in range(self.max_replicas):
                if rid in self._in_flight[i]:
                    del self._in_flight[i][rid]
                    # engine-side claw-back: the holder consumes this
                    # at its next handshake and frees slot + KV blocks
                    self._cancels[i].add(rid)
                # a routed-but-unclaimed copy: drop it HERE — the
                # inbox drain in _sync_locked does not re-check
                # _done_rids, so a stale entry would be assigned
                try:
                    self._inbox[i].remove(h)
                except ValueError:
                    pass
            for tb in self._taint_base:
                tb.pop(rid, None)
            for cm in self._canary_mark:
                cm.pop(rid, None)
            self.cancelled += 1
            h.error = RequestCancelled(
                "request %d cancelled by client with %d token(s) "
                "emitted%s" % (rid, len(toks),
                               "" if h.conn is None
                               else " (conn %s)" % h.conn),
                rid=rid, tokens=toks)
            self._pending_journal.append(self._journal.cancel(
                rid, toks, conn=h.conn, defer=True))
            self._stream_queue_locked(h, [], closing=True)
            self._pending_events.append(h)
            self._cond.notify_all()
        self._flush_journal()
        return True

    def _dispatch_locked(self):
        """Drain the weighted fair queue into replica inboxes while
        the dispatch window has room (caller holds `_cond`). Called at
        submit and at every replica handshake / monitor sweep, so a
        completion's freed capacity admits the smallest-finish-tag
        request next — the fairness decision point. Entries whose rid
        already went terminal (a close() sweep) are skipped; a
        deadline that died queueing gets its expired verdict HERE,
        before any replica spends anything on it."""
        if self._wfq is None or not self._wfq:
            return
        live = sum(1 for s in self._state if s == _LIVE)
        limit = (self._wfq_window if self._wfq_window is not None
                 else max(1, live) * self._slots_per_replica)
        now = time.monotonic()
        # deadline sweep over WAITING entries first: with the window
        # full the pop loop below never runs, and a deadline that died
        # queueing must still get its verdict at this hop (the
        # every-queue-hop rule) — never a silent FleetTimeout. The
        # handle stays in the heap; the pop-time done-check skips it.
        for h in self._wfq.entries():
            if not h.done and h.rid not in self._done_rids \
                    and h.deadline_at is not None \
                    and now >= h.deadline_at:
                self._expire_locked(h)
        while self._wfq:
            out = sum(len(self._inbox[i]) + len(self._in_flight[i])
                      for i in range(self.max_replicas))
            if out >= limit:
                break
            h = self._wfq.pop()
            if h.done or h.rid in self._done_rids:
                continue  # went terminal while queued (close/reject)
            if h.deadline_at is not None and now >= h.deadline_at:
                self._expire_locked(h)
                continue
            try:
                self._route(h, exclude=None)
            except EngineFailed:
                pass  # no live replica: _route already failed it

    def _route(self, h: FleetHandle, exclude: Optional[int]):
        """Pick a replica for `h` (caller holds `_cond`): longest
        cached-prefix match against the pool summaries, ties broken by
        load; SLO class first, any live replica as fallback; no live
        replica at all fails the handle."""
        live = [i for i in range(self.max_replicas)
                if self._state[i] == _LIVE and i != exclude]
        if not live:
            # slow beats dead, the _demote_locked rule — but deaths can
            # make a DEMOTED replica the last one alive, and it is warm,
            # heartbeating, and parked only by our own health verdict:
            # strictly better than terminally rejecting every request
            # (probes restore it the moment it behaves; a real death
            # still fails over through the heartbeat deadline)
            live = [i for i in range(self.max_replicas)
                    if self._state[i] == _DEMOTED and i != exclude]
        cands = live
        if self._tiered:
            # disaggregation placement: a request with no
            # resumed prefix needs its PREFILL computed — prefill-tier
            # replica; a resumed one (migration, hedge, restart) is in
            # its decode phase — decode-tier replica. None-tier
            # replicas serve both; survival beats tier placement. The
            # tier filter runs BEFORE the SLO filter: tier is the
            # STRUCTURAL phase split, SLO a scheduling preference — if
            # SLO narrowed first, a decode tier whose class differs
            # from the request's would be invisible here, and a
            # migration gated on "a decode-capable replica exists"
            # would land on another prefill replica and ping-pong
            # (re-prefilling the growing prefix every hop) forever
            want = "decode" if h.resume else "prefill"
            tcands = [i for i in cands
                      if self._replica_tier[i] in (want, None)]
            if tcands:
                cands = tcands
        scands = [i for i in cands if self._replica_slo[i] in (None, h.slo)]
        if scands:
            cands = scands  # SLO preference within the tier; survival
            #                 beats SLO placement when none matches
        if not cands:
            # terminal: the caller gets the error NOW, so the request
            # must not stay open (journal-wise) to be resubmitted by
            # every future recover(); prune like _accept does
            # event fires at flush, AFTER the reject record is on disk
            # (submit's caller still gets the raise synchronously)
            self._reject_locked(
                h.rid, "no live replica", fire=True,
                error=EngineFailed(
                    "no live replica for request %d" % h.rid,
                    replica=None))
            raise h.error
        best, best_key = None, None
        # store-aware affinity: a chain the durable store
        # holds is cheap for ANY replica to restore (warm/handoff), so
        # routing credits store-held keys to every candidate equally —
        # resident beats absent, ties break by load as ever
        store_keys = (self.kv_store.summary()
                      if self.kv_store is not None and self.affinity
                      and h.chain else ())
        for i in cands:
            depth = 0
            if self.affinity and h.chain:
                s = self._summaries[i]
                for key in h.chain:
                    if key not in s and key not in store_keys:
                        break
                    depth += 1
            load = len(self._inbox[i]) + len(self._in_flight[i])
            key = (-depth, load, i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        rep = self._replicas[best]
        self._inbox[best].append(h)
        # taint base: the resume prefix was produced (and
        # vouched for) by EARLIER holders — if this assignee trips, its
        # taint window opens at the resume boundary, never before it.
        # A later clean canary on the replica advances the base.
        self._taint_base[best][h.rid] = len(h.resume)
        # mirror updates NOW (a failover consulting lost() must see
        # this assignment); the file record flushes after the lock.
        # tier + weights_version ride the record as the version-fence
        # side-band (journal DFA J009)
        self._pending_journal.append(self._journal.assign(
            h.rid, rep.name, rep.incarnation, h.generation,
            tier=rep.tier, weights_version=rep.weights_version,
            tenant=h.tenant, handoff=h.handoff_meta, defer=True))
        # the side-band describes THIS assignment only: a later
        # re-route without a fresh package must not re-stamp it (the
        # package itself stays on the handle until the assignee's
        # submit consumes it — or a newer re-route replaces it)
        h.handoff_meta = None
        self._cond.notify_all()

    def _flush_journal(self):
        """Write journal records produced under the lock, THEN release
        the waiters whose completions those records describe — called
        by every entry point after dropping the lock (submit, replica
        syncs, monitor sweeps, drain, close). The ordering makes the
        journal read-your-writes for anyone a result just unblocked.
        The swap and the file write happen as ONE unit under
        `_flush_lock` (outer to `_cond`, never taken while holding
        it): concurrent flushers must hit the file in swap order, or
        a rid's progress deltas could land inverted on disk while the
        mirror has them straight — and a restarted front door would
        resume a scrambled token prefix."""
        if self._hook is not None:
            self._hook.yield_point("journal:flush")
        fired: List[FleetHandle] = []
        with self._flush_lock:
            with self._cond:
                if not self._pending_journal \
                        and not self._pending_events \
                        and not self._pending_stream:
                    return
                pending, self._pending_journal = self._pending_journal, []
                fired, self._pending_events = self._pending_events, []
                streams, self._pending_stream = self._pending_stream, []
            if pending:
                self._journal.write(pending)
        # stream deliveries BEFORE completion events: a waiter whose
        # result() just unblocked must find its stream already closed
        # (both ride the same flush, so both are read-your-writes)
        for h, toks, closing in streams:
            h._stream_feed(toks, closing)
        for h in fired:
            h._event.set()

    def _stream_queue_locked(self, h: FleetHandle, tokens,
                             closing: bool = False):
        """Queue journaled tokens (and/or the terminal close) for a
        streaming handle (caller holds `_cond`): _flush_journal feeds
        them AFTER the file write. Advances the handle's stream cursor
        here, under the scheduler lock, so a failover's re-journaled
        resume prefix — already queued once — is never delivered
        twice. No-op for non-streaming handles."""
        if not h.streaming:
            return
        toks = [int(t) for t in tokens] if tokens else []
        if toks:
            h._stream_sent += len(toks)
        if toks or closing:
            self._pending_stream.append((h, toks, closing))

    def _reject_locked(self, rid: int, reason: str, error=None,
                       fire: bool = False) -> Optional[FleetHandle]:
        """Terminal `rejected` bookkeeping for an open rid (caller
        holds `_cond`): prune every in-memory mirror, count it, queue
        the journal record. The ONE place the reject invariant lives —
        engine-admission failure, the no-live-replica route, submit's
        close race, and close() all share it, so a future change to
        the terminal shape cannot desynchronize the journal from the
        mirrors at just one site. `error` lands on a not-yet-done
        handle; `fire` queues its event for the post-flush release
        (read-your-writes for the waiter it unblocks). Idempotent: a
        rid that is already terminal (close()'s open-request sweep
        racing submit's close branch reaches the same rid from both
        sides) is left alone — a second pass would double-count
        `rejected` and journal a duplicate terminal record, driving
        stats()['lost'] negative."""
        if rid in self._done_rids and "double_reject" not in _MUTANTS:
            return self._handles.pop(rid, None)
        h = self._handles.pop(rid, None)
        self._open.discard(rid)
        self._done_rids.add(rid)
        for fl in self._in_flight:
            fl.pop(rid, None)
        for tb in self._taint_base:
            tb.pop(rid, None)
        for cm in self._canary_mark:
            cm.pop(rid, None)
        self.rejected += 1
        if h is not None and h.tenant is not None \
                and self._tenants is not None:
            self._tenants.on_reject(h.tenant)
        self._pending_journal.append(self._journal.reject(
            rid, reason, defer=True))
        if h is not None and not h.done:
            if error is not None:
                h.error = error
            self._stream_queue_locked(h, [], closing=True)
            if fire:
                self._pending_events.append(h)
        return h

    def _reject(self, rid: int, exc: Exception, rep=None):
        """A single malformed request failed engine admission, or a
        batch-lane job raised: fail it alone (called from replica
        threads), with a TERMINAL journal record — an unservable
        request must not stay open forever and be resubmitted by every
        future recover(). `rep` (the reporting replica) arms the SAME
        journal-lease fence completions get in `_accept`: a demoted/
        superseded holder whose local copy fails must not terminally
        reject a rid a healthy survivor is re-running — its report is
        refused (zombie_refused) and the survivor's verdict stands."""
        with self._cond:
            h = self._handles.get(rid)
            if h is None or h.done:
                return
            if rep is not None and not h._probe:
                a = self._journal.assigned_to(rid)
                if a is None or a[0] != rep.name \
                        or a[1] != rep.incarnation \
                        or rid not in self._in_flight[rep.index]:
                    self.zombie_refused += 1
                    return
            if h._probe:
                # a probe that failed engine ADMISSION is a failed
                # probe, not a rejected request: journaling its
                # negative rid would corrupt the durable table and
                # stats()["lost"], and leaving _probes[i] set would
                # stop all future probes — the replica would stay
                # DEMOTED forever with no path back
                for i, ph in enumerate(self._probes):
                    if ph is h:
                        self._probes[i] = None
                        self._probe_ok[i] = 0
                        self._probe_at[i] = (time.monotonic()
                                             + self.probe_interval_s)
                self._handles.pop(rid, None)
                # the handshake tracked the probe in-flight when it was
                # handed out; a leaked negative rid would block the
                # DRAINING->DRAINED transition forever and inflate this
                # replica's routing load on every failed probe
                for fl in self._in_flight:
                    fl.pop(rid, None)
                h._event.set()
                self._cond.notify_all()
                return
            self._reject_locked(rid, repr(exc), error=exc, fire=True)
            self._cond.notify_all()
        self._flush_journal()

    # -- replica protocol ------------------------------------------------
    def _sync(self, rep: _Replica, completed, progress, idle: bool,
              summary: Optional[Set[int]],
              stats: Optional[dict]):  # thread: replica
        """One replica scheduler handshake: report completions (fenced
        + deduped) and incremental token progress (fenced the same
        way, batched into flush-deferred journal records), heartbeat,
        absorb the pool summary, pick up new work and cancellations.
        The 4th element of the return asks the replica to RESEND its
        pool summary even though the pool revision is unchanged (the
        post-restore refresh). Returns ("stop", [], [], False) when
        this replica object is no longer the registered incarnation
        (fenced zombie, closing fleet) — the loop must exit. May raise
        `_KillDrill`."""
        ret = self._sync_locked(rep, completed, progress, idle, summary,
                                stats)
        self._flush_journal()
        return ret

    def _sync_locked(self, rep: _Replica, completed, progress, idle: bool,
                     summary: Optional[Set[int]],
                     stats: Optional[dict]):  # thread: replica
        with self._cond:
            i = rep.index
            current = (self._replicas[i] is rep
                       and self._state[i] not in (_DEAD, _RETIRED))
            if current:
                self._beats[i] = time.monotonic()
                if stats is not None:
                    # stored BEFORE completions are judged: a probe
                    # completion in this batch must be scored against
                    # the step-latency EWMA that rode the SAME
                    # handshake, not the previous one's snapshot
                    self._rep_stats[i] = stats
                self._absorb_progress(rep, progress)
            for rid, tokens, reason, outcome in completed:
                self._accept(rid, tokens, reason, rep, accepted=current,
                             outcome=outcome)
            if not current or self._closing \
                    or self._replicas[i] is not rep \
                    or self._state[i] in (_DEAD, _RETIRED):
                # the re-check matters: a canary MISMATCH judged in the
                # _accept loop above quarantines this very replica
                # — its own handshake must observe the
                # verdict and stop, not pick up another round of work
                return "stop", [], [], False
            if summary is not None:
                self._summaries[i] = summary
            if self._wfq is not None:
                # the completions judged above freed dispatch-window
                # capacity: admit the smallest-finish-tag WFQ entries
                # now — every handshake is a fairness decision point
                self._dispatch_locked()
            if self._kill[i]:
                self._kill[i] = False
                raise _KillDrill("replica %s killed by drill" % rep.name)
            if self._tiered and rep.tier == "prefill" \
                    and self._state[i] == _LIVE:
                # disaggregation migration: any in-flight
                # request that produced NEW tokens on this prefill
                # replica has finished its prefill — hand it to a
                # decode-tier replica via the journaled resume path.
                # Runs AFTER completions were judged, so a request
                # that already finished here is never migrated, and
                # the cancel lands in THIS handshake's return — the
                # prefill engine never spends another step on it
                self._maybe_migrate_locked(rep)
            if self._state[i] == _DRAINING and idle \
                    and not self._inbox[i] and not self._in_flight[i]:
                if self._retire_flag[i]:
                    # autoscaler scale-down completes: fold the
                    # incarnation's stats into the cumulative base
                    # (fleet totals stay monotonic), free the slot,
                    # and stop the thread — the graceful half of the
                    # supervisor's restart story
                    self._retire_flag[i] = False
                    self._state[i] = _RETIRED
                    self._fold_stats_locked(i)
                    self._summaries[i] = set()
                    self.replicas_retired += 1
                    self._cond.notify_all()
                    return "stop", [], [], False
                self._state[i] = _DRAINED
                self._cond.notify_all()
            if self._state[i] == _DRAINED:
                # parked: wait for refill/close; the monitor exempts
                # DRAINED replicas from the heartbeat deadline
                self._cond.wait(timeout=self._idle_wait_s)
                return "park", [], [], False
            resync = self._want_summary[i]
            if resync:
                self._want_summary[i] = False
            cancels = list(self._cancels[i])
            self._cancels[i].clear()
            work: List[FleetHandle] = []
            now = time.monotonic()
            q = self._inbox[i]
            while q:
                h = q.popleft()
                if not h._probe and h.deadline_at is not None \
                        and now >= h.deadline_at:
                    # the ROUTING hop's deadline check: the budget died
                    # in the inbox — verdict now, zero engine steps
                    self._expire_locked(h)
                    continue
                self._in_flight[i][h.rid] = h
                work.append(h)
            if not work and not cancels and idle:
                # nothing to do: sleep on the condition (bounded, so
                # heartbeats keep flowing) instead of spinning
                self._cond.wait(timeout=self._idle_wait_s)
            return "run", work, cancels, resync

    def _absorb_progress(self, rep: _Replica, progress):
        """Journal incremental emitted tokens (caller holds `_cond`;
        the file records are deferred to the post-lock flush). FENCED
        like completions: only the journal-assigned holder's progress
        counts — a demoted replica racing its hedged survivor must not
        interleave tokens into the mirror the survivor resumes from."""
        for rid, delta in progress:
            h = self._handles.get(rid)
            if h is None or h.done or h._probe:
                continue
            a = self._journal.assigned_to(rid)
            if a is None or a[0] != rep.name or a[1] != rep.incarnation:
                continue  # stale holder: journal fence refuses
            if rid not in self._in_flight[rep.index]:
                # clawed back (demotion hedge) and possibly routed BACK
                # here under a bumped generation still in the inbox:
                # the journal names this replica again, but this delta
                # is from the superseded submission — the mirror the
                # new holder resumes from must not absorb it
                continue
            rec = self._journal.progress(
                rid, rep.name, rep.incarnation, h.generation, delta,
                conn=h.conn, stream=h.streaming, defer=True)
            self._pending_journal.append(rec)
            if h.streaming:
                # stream exactly the journal's accumulation: the
                # record's cursor is the accumulated length AFTER this
                # delta, so indices below the handle's cursor (a taint
                # window's sanctioned re-decode of already-delivered
                # tokens) are never pushed twice
                start = rec["stream"] - len(rec["tokens"])
                fresh = rec["tokens"][max(0, h._stream_sent - start):]
                self._stream_queue_locked(h, fresh)
            h.emitted += len(delta)
            if h.ttft_s is None:  # fleet-level TTFT: first journaled token
                h.ttft_s = time.monotonic() - h._submit_t

    def _maybe_migrate_locked(self, rep: _Replica):  # band-verb: resume
        """Migrate requests whose prefill finished on this PREFILL-tier
        replica to a decode-tier replica (caller holds `_cond`). The
        trigger is journaled progress BEYOND the request's resumed
        prefix — the first token only exists once the whole prompt was
        prefilled, so this is exactly the prefill/decode phase
        boundary. Mechanism is the hedge, on purpose instead of on
        failure: bump the generation, resubmit with the journaled
        prefix as `resume_tokens` (the decode replica prefill-aliases
        it and re-decodes ZERO journaled tokens), queue a cancel this
        replica consumes in the SAME handshake. Skipped when no other
        live decode-capable replica exists — a migration that could
        only route back here (or fail the handle) is worse than
        letting the prefill replica decode."""
        i = rep.index
        if not any(self._state[j] == _LIVE
                   and self._replica_tier[j] in ("decode", None)
                   for j in range(self.max_replicas) if j != i):
            return
        for rid in list(self._in_flight[i]):
            h = self._handles.get(rid)
            if h is None or h.done or h._probe:
                continue
            toks = self._journal.progress_of(rid)
            if len(toks) <= len(h.resume):
                continue  # still prefilling: no new token yet
            self._cancels[i].add(rid)
            self._in_flight[i].pop(rid, None)
            if self._finished_in_journal(h.spec, toks):
                # the first token already satisfied the budget/EOS:
                # complete straight from the journal, zero extra hops
                self._complete_from_progress(
                    h, toks, rep.name, rep.incarnation)
                continue
            h.generation += 1
            h.resume = list(toks)  # replace wholesale, never mutate
            self.migrations += 1
            self.resubmitted += 1
            self.resumed_requests += 1
            self.resumed_tokens += len(toks)
            self._attach_handoff_locked(h, toks)
            try:
                self._route(h, exclude=i)
            except EngineFailed:
                pass  # no survivors: handle already failed by _route

    def _attach_handoff_locked(self, h: FleetHandle, toks: List[int]):  # band-verb: import
        """Build the checksummed block package for a resumed request
        (caller holds `_cond`): the durable KV tier ships the finished
        prefix's closed blocks to the resuming replica so re-prefill
        becomes the FALLBACK path, not the plan. The store
        lookup is fingerprint-carrying — the target verifies each block
        after upload and falls back per-block on mismatch — and the
        assign record's `handoff` side-band (length + fp digest) lets
        the journal audit tie the done to THIS transfer (J011)."""
        if self.kv_store is None or not self.handoff:
            return
        package = self.kv_store.chain_fetch(
            list(h.prompt) + list(toks), self.block_tokens)
        if package:
            h.handoff_package = package
            h.handoff_meta = {
                "len": len(package) * self.block_tokens,
                "digest": fp_digest(r["fp"] for r in package)}
            self.handoff_packages += 1

    def _accept(self, rid: int, tokens: List[int], reason: str,
                rep: _Replica, accepted: bool, outcome=None):
        """Completion fence + dedupe (caller holds `_cond`): refuse a
        dead/superseded replica's late result, refuse a STALE holder's
        result (the journal's latest assignment is the lease — a
        demoted replica racing the survivor its work was hedged to
        loses, exactly like a zombie lease-holder), refuse a second
        answer for an already-done rid. `tokens` are the reporting
        incarnation's NEWLY generated tokens; the resumed prefix is
        prepended here so the caller always sees the full output."""
        if rid < 0:  # internal health probe / canary: never journaled
            self._in_flight[rep.index].pop(rid, None)
            h = self._handles.get(rid)
            if h is not None and h._canary:
                self._canary_done(rep, h, tokens, ok=accepted)
                return
            ph = self._probes[rep.index]
            if ph is not None and ph.rid == rid:
                # identity-routed: a DROPPED canary's late completion
                # (its handle already released at demote/drain) must
                # not masquerade as health-probe evidence and credit a
                # restore the probe never earned
                self._probe_done(rep, completed_ok=accepted)
            return
        if not accepted:
            self.zombie_refused += 1
            return
        if rid in self._cancelled_rids:
            # the holder finished work the client already abandoned —
            # the cancel's expected tail (the engine-side claw-back
            # races the final steps by design), NOT a duplicate
            # answer: duplicate_refused must stay 0 under disconnect
            # drills or the exactly-once bar loses its meaning
            self.cancel_late_refused += 1
            return
        if rid in self._done_rids:
            self.duplicate_refused += 1
            return
        h = self._handles.get(rid)
        if h is None or h.done:
            self.duplicate_refused += 1
            return
        a = self._journal.assigned_to(rid)
        if a is not None and (a[0] != rep.name or a[1] != rep.incarnation):
            # hedged elsewhere: this holder's lease is stale
            self.zombie_refused += 1
            return
        if rid not in self._in_flight[rep.index] \
                and "superseded_report" not in _MUTANTS:
            # the (replica, incarnation) pair can RE-match after a
            # demote -> survivor-death -> route-back-to-demoted cycle:
            # the journal's latest assignment names this replica again
            # while the bumped-generation copy is still in its inbox
            # (inboxes drain AFTER completions in this handshake). A
            # report for work the fleet does not track in-flight here
            # is from the superseded submission — accepting it would
            # prepend h.resume to tokens that already contain it
            self.zombie_refused += 1
            return
        full = list(h.resume) + list(tokens)
        if reason == "expired":
            self._expire_locked(h, tokens=full)
            return
        self._done_rids.add(rid)
        self._in_flight[rep.index].pop(rid, None)
        self._taint_base[rep.index].pop(rid, None)
        self._canary_mark[rep.index].pop(rid, None)
        self._open.discard(rid)
        # prune the handle (the caller holds its own reference): a
        # long-lived front door must not retain every prompt + output
        # it ever served — _done_rids (ints) carries the dedupe
        self._handles.pop(rid, None)
        # handoff fence: an assignment that shipped a block
        # package MUST account for it at the done — verified import or
        # counted fallback, never silence (protocol_lint J011). An
        # engine that cannot report (scripted drills) gets the honest
        # default: nothing imported, re-prefill fallback.
        _tier, _wv, _ten, ho = self._journal.assigned_meta(rid)
        if ho is not None and outcome is None:
            outcome = {"imported": 0, "fallback": True}
            self.handoff_fallbacks_defaulted += 1
        self._pending_journal.append(self._journal.complete(
            rid, rep.name, rep.incarnation, h.generation, full,
            weights_version=rep.weights_version, tenant=h.tenant,
            handoff=outcome, defer=True))
        h.tokens = full
        h.replica = rep.name
        h.weights_version = rep.weights_version
        # stream tail + close: whatever the cursor has not delivered
        # yet (the final handshake's tokens ride the done record, not
        # a progress record) — concatenation lands bit-identical to
        # result()'s generated half
        self._stream_queue_locked(h, full[h._stream_sent:],
                                  closing=True)
        if h.tenant is not None and self._tenants is not None:
            # per-tenant O(1) accounting: completion,
            # tokens served, and the latency the tenant actually saw
            self._tenants.on_complete(
                h.tenant, len(full),
                queue_wait_s=(h.ttft_s if h.ttft_s is not None
                              else time.monotonic() - h._submit_t),
                batch=h.batch_fn is not None)
            if h.batch_fn is not None:
                self.batch_jobs_completed += 1
        # the event fires in _flush_journal, AFTER the done record is
        # on disk — result() observers get read-your-writes recovery
        self._pending_events.append(h)
        self.completed += 1
        self._cond.notify_all()

    def _expire_locked(self, h: FleetHandle, tokens=None):
        """Terminal `expired` verdict for an open request (caller holds
        `_cond`): the deadline died — journal it, fail the handle with
        `DeadlineExceeded`, stop spending anything on it. A verdict,
        never a silent hang."""
        rid = h.rid
        if h.done or rid in self._done_rids:
            return
        toks = (list(tokens) if tokens is not None
                else self._journal.progress_of(rid))
        h.error = DeadlineExceeded(
            "request %d expired with %d/%d token(s) emitted "
            "(deadline_s=%r)" % (
                rid, len(toks), h.spec["max_new_tokens"],
                h.spec.get("deadline_s")),
            rid=rid, tokens=toks)
        self._done_rids.add(rid)
        self._open.discard(rid)
        self._handles.pop(rid, None)
        for fl in self._in_flight:
            fl.pop(rid, None)
        for tb in self._taint_base:
            tb.pop(rid, None)
        for cm in self._canary_mark:
            cm.pop(rid, None)
        self.expired += 1
        if h.tenant is not None and self._tenants is not None:
            self._tenants.on_expire(h.tenant)
        self._pending_journal.append(self._journal.expire(
            rid, toks, defer=True))
        # close (no tokens): the iterator reports DeadlineExceeded
        # after the delivered prefix, exactly like result()
        self._stream_queue_locked(h, [], closing=True)
        self._pending_events.append(h)
        self._cond.notify_all()

    def _on_crash(self, rep: _Replica, exc: BaseException):  # thread: replica
        # unwrap engine-latch wrappers: the FIRST failure decides the
        # recovery path — an IntegrityError (trap, fingerprint, spike)
        # takes the quarantine + taint route, anything else the plain
        # failover that trusts journaled progress
        root = exc
        while isinstance(root, EngineFailed) and root.__cause__ is not None:
            root = root.__cause__
        # final stats snapshot, taken ON the dying replica's own thread
        # (the engine is confined here): without it, counters that
        # moved between the last handshake and the crash — an integrity
        # trip's fingerprint mismatch above all — would never fold into
        # the fleet totals
        try:
            final_stats = rep._stats()
        except Exception:
            final_stats = None
        with self._cond:
            if self._replicas[rep.index] is rep and final_stats is not None:
                self._rep_stats[rep.index] = final_stats
            if isinstance(root, IntegrityError):
                self._integrity_trip_locked(rep.index, rep, root)
            else:
                self._fail_over(rep.index, rep, exc)
        self._flush_journal()

    # -- failure handling ------------------------------------------------
    def _fold_stats_locked(self, i: int):
        """Fold an ending incarnation's last stats snapshot into the
        fleet-wide cumulative base (caller holds `_cond`): totals must
        not decrease on refill OR retirement. Gauges die with the
        incarnation. Shared by the death path (_fail_over), the
        autoscaler's retirement, and the rollout swap."""
        st = self._rep_stats[i]
        if st:
            for k, v in st.items():
                if k in _GAUGE_STATS:
                    continue  # gauges: die with the incarnation
                self._stats_base[k] = self._stats_base.get(k, 0) + v
        self._rep_stats[i] = None

    def _fail_over(self, i: int, rep: _Replica, exc: BaseException):
        """Declare replica `i` dead and resubmit its journal-recorded
        open requests to survivors (caller holds `_cond`). Idempotent
        per incarnation: the crash path and the heartbeat path can both
        land here."""
        if self._replicas[i] is not rep or self._state[i] == _DEAD:
            return
        self._state[i] = _DEAD
        self._summaries[i] = set()
        self.failovers += 1
        self._fold_stats_locked(i)
        # rapid-death accounting gates auto_refill AND the autoscaler's
        # spawn picker (exponential backoff, the Supervisor's
        # restart/backoff discipline — literally supervisor.py's
        # restart_backoff_s schedule): a deterministically-failing
        # replica must not crash/refill at monitor frequency forever
        rapid = time.monotonic() - self._spawned[i] < 2.0
        self._rapid[i] = self._rapid[i] + 1 if rapid else 0
        self._refill_at[i] = time.monotonic() + _backoff(
            self._rapid[i] + 1, base=0.05)
        self._inbox[i].clear()
        self._in_flight[i].clear()
        self._cancels[i].clear()
        self._slow_since[i] = None
        self._watermark[i] = None
        self._rate[i] = None
        self._stall_since[i] = None
        # an outstanding health probe dies with the replica (it was
        # never journaled — nothing to recover); release its handle so
        # repeated probe-interrupted deaths cannot accumulate them
        if self._probes[i] is not None:
            self._handles.pop(self._probes[i].rid, None)
            self._probes[i]._event.set()
            self._probes[i] = None
        self._probe_ok[i] = 0
        # the canary (never journaled) and the taint-base
        # marks die with the incarnation — the integrity trip path
        # already consumed the marks it needed BEFORE calling here
        self._drop_canary_locked(i)
        self._taint_base[i] = {}
        self._canary_mark[i] = {}
        self._want_summary[i] = False  # a fresh incarnation sends anew
        # the JOURNAL is the recovery source: every open request whose
        # latest assignment names this replica+incarnation, resumed
        # from its journaled progress — the survivor prefill-aliases
        # the emitted prefix and re-decodes NOTHING
        self._resubmit_lost(i, rep)
        self._cond.notify_all()

    @staticmethod
    def _finished_in_journal(spec: dict, toks: List[int]) -> bool:
        """True when a journaled emitted-token prefix already satisfies
        the request (budget reached, or `eos_id` emitted): completing
        it needs zero engine work."""
        if not toks:
            return False
        eos = spec["eos_id"]
        return (len(toks) >= int(spec["max_new_tokens"])
                or (eos is not None and toks[-1] == int(eos)))

    def _complete_from_progress(self, h: FleetHandle, toks: List[int],
                                replica: str, incarnation: int):
        """Terminal completion straight from journaled progress (caller
        holds `_cond`): a lost holder — a dead incarnation, or a
        crashed front door on restart — actually FINISHED the request
        and only its done record was lost. No engine steps are spent,
        no token is re-decoded."""
        rid = h.rid
        self._done_rids.add(rid)
        self._open.discard(rid)
        self._handles.pop(rid, None)
        # the version of the holder that actually produced the tokens
        # (read BEFORE complete() prunes the assignment side-band)
        _tier, wv, _ten, ho = self._journal.assigned_meta(rid)
        # the holder died before reporting whether it imported its
        # block package — the audit gets the conservative default, not
        # silence (J011: every shipped package accounts for itself)
        outcome = None
        if ho is not None:
            outcome = {"imported": 0, "fallback": True}
            self.handoff_fallbacks_defaulted += 1
        self._pending_journal.append(self._journal.complete(
            rid, replica, incarnation, h.generation, list(toks),
            weights_version=wv, tenant=h.tenant, handoff=outcome,
            defer=True))
        h.tokens = list(toks)
        h.emitted = len(toks)
        h.replica = replica
        h.weights_version = wv
        self._stream_queue_locked(h, toks[h._stream_sent:],
                                  closing=True)
        if h.tenant is not None and self._tenants is not None:
            self._tenants.on_complete(
                h.tenant, len(toks),
                queue_wait_s=(h.ttft_s if h.ttft_s is not None
                              else time.monotonic() - h._submit_t),
                batch=h.batch_fn is not None)
        self._pending_events.append(h)
        self.completed += 1

    def _resubmit_lost(self, i: int, rep: _Replica, lost=None):  # band-verb: resume
        """Hedge/recover every open request the journal assigns to
        (rep, incarnation) onto survivors, carrying the emitted-token
        prefix (caller holds `_cond`). `lost` lets a caller that
        already scanned the journal (demotion builds its cancel set
        from the same list) pass the result in instead of paying the
        O(open x emitted) copy twice under `_cond`."""
        if lost is None:
            lost = self._journal.lost(rep.name, rep.incarnation)
        for rid, _spec, _gen, toks in lost:
            h = self._handles.get(rid)
            if h is None or h.done:
                continue
            if h.deadline_at is not None \
                    and time.monotonic() >= h.deadline_at:
                # already out of budget: expiring NOW is the verdict —
                # resubmitting would spend survivor steps on a corpse
                self._expire_locked(h, tokens=toks)
                continue
            if self._finished_in_journal(h.spec, toks):
                self._complete_from_progress(
                    h, toks, rep.name, rep.incarnation)
                continue
            h.generation += 1
            h.resume = list(toks)  # replace wholesale, never mutate
            self.resubmitted += 1
            if toks:
                self.resumed_requests += 1
                self.resumed_tokens += len(toks)
            self._attach_handoff_locked(h, toks)
            try:
                self._route(h, exclude=i)
            except EngineFailed:
                pass  # no survivors: handle already failed by _route

    def _monitor_loop(self):  # thread: monitor
        if self._hook is not None:
            self._hook.thread_started("monitor", "mon")
        try:
            self._monitor_loop_body()
        finally:
            if self._hook is not None:
                self._hook.thread_exiting()

    def _monitor_loop_body(self):  # thread: monitor
        while True:
            if self._hook is not None:
                self._hook.yield_point("monitor:sweep")
            with self._cond:
                if self._closing:
                    return
                now = time.monotonic()
                for i, rep in enumerate(self._replicas):
                    if self._state[i] in (_LIVE, _DRAINING, _DEMOTED) \
                            and now - self._beats[i] > self.heartbeat_timeout_s:
                        # gray shades into black: a demoted replica
                        # that stops even heartbeating is plain dead
                        self._fail_over(
                            i, rep,
                            TimeoutError(
                                "replica %s missed heartbeat deadline "
                                "(%.2fs)" % (rep.name,
                                             self.heartbeat_timeout_s)))
                    elif self._state[i] == _DEAD and self.auto_refill \
                            and now >= self._refill_at[i]:
                        self._refill_locked(i)
                if self.slow_replica_factor is not None:
                    self._health_sweep(now)
                if self.canary_interval_s is not None:
                    self._canary_sweep(now)
                if self.min_replicas < self.max_replicas:
                    self._scale_sweep(now)
                if self._wfq is not None:
                    # an all-idle fleet must still drain the fair
                    # queue (deaths/refills change the window too)
                    self._dispatch_locked()
            self._flush_journal()  # fail-over resubmissions above
            time.sleep(self._monitor_interval_s)

    # -- gray-failure detection --------------------------------
    def _live_ewmas(self) -> List[float]:  # holds: _cond
        out = []
        for i in range(self.max_replicas):
            st = self._rep_stats[i]
            if self._state[i] == _LIVE and st \
                    and st.get("step_ewma_s", 0.0) > 0.0:
                out.append(float(st["step_ewma_s"]))
        return out

    def _health_sweep(self, now: float):  # thread: monitor, holds: _cond
        """Score every live replica against the fleet. The health score
        combines BOTH signals, and demotion needs both to
        agree: (a) step-latency EWMA past `slow_replica_factor` x the
        live (lower) median — necessary but NOT sufficient, because a
        replica carrying more slots / prefill chunks / GIL contention
        has honestly longer steps; (b) the decode-progress WATERMARK
        (tokens emitted per wall-second, sampled over >= 0.15 s
        windows) below the live median by the same factor — a busy
        replica still emitting at fleet-comparable rate is never
        demoted, however long its steps look. A watermark FLAT for the
        whole hysteresis window while busy is gray on its own (the
        wedged-but-syncing shape). Sustained past `slow_min_duration_s`
        (one GC pause decays out of the EWMA in a few healthy steps
        and resets the clock), the replica is demoted: drained +
        probed, not killed. Demoted replicas are probed on
        `probe_interval_s` until healthy, then restored — same
        incarnation, warm pool."""
        ewmas = self._live_ewmas()
        median = _lower_median(ewmas)
        rate_window = max(0.15, 2.0 * self._monitor_interval_s)
        rates = [self._rate[i] for i in range(self.max_replicas)
                 if self._state[i] == _LIVE and self._rate[i] is not None]
        median_rate = _upper_median(rates)
        for i in range(self.max_replicas):
            st = self._rep_stats[i]
            if self._state[i] == _DEMOTED:
                if self._probes[i] is None and now >= self._probe_at[i]:
                    self._send_probe_locked(i)
                continue
            if self._state[i] != _LIVE or not st:
                continue
            # judge only FRESH evidence: _rep_stats is a snapshot from
            # the replica's last handshake. A replica silent inside one
            # long step (a first compile — the documented
            # false-demotion hazard) freezes busy/tokens/EWMA; scoring
            # that stale picture would demote it for compiling. A
            # replica that stays silent past the window here simply
            # isn't judged (the heartbeat deadline owns total silence);
            # a GRAY replica still syncs every (stalled) step, so it
            # keeps producing fresh evidence and IS judged. The window
            # is 2x the hysteresis duration: a gray step is the stall
            # PLUS real compute, and a gate at exactly
            # slow_min_duration_s would discard evidence from a gray
            # replica whose stalled steps run just past it — while a
            # compile (seconds) stays far beyond 2x.
            if now - self._beats[i] > 2.0 * self.slow_min_duration_s:
                self._slow_since[i] = None
                self._watermark[i] = None
                self._rate[i] = None
                self._stall_since[i] = None
                continue
            # the progress counter includes PREFILL work: a replica
            # grinding a long prompt through chunks emits no tokens
            # for a while but is making honest progress — counting
            # only emissions would read the prefill phase as a stall
            # (and bias the rate veto against prefill-heavy replicas)
            tokens = int(st.get("tokens_out", 0)) \
                + int(st.get("prefill_tokens_computed", 0))
            busy = bool(st.get("busy"))
            stalled = False
            if busy:
                wm = self._watermark[i]
                if wm is None:
                    self._watermark[i] = (now, tokens)
                elif now - wm[0] >= rate_window \
                        and self._beats[i] > wm[0]:
                    # sample only when the replica SYNCED since the
                    # last sample: flat progress across syncs is a
                    # stall; silence (one long step — a compile) is
                    # not evidence of anything, and when the sync
                    # finally lands the token jump clears the flag
                    self._rate[i] = (tokens - wm[1]) / (now - wm[0])
                    if tokens <= wm[1]:
                        if self._stall_since[i] is None:
                            self._stall_since[i] = wm[0]
                        stalled = (now - self._stall_since[i]
                                   >= self.slow_min_duration_s)
                    else:
                        self._stall_since[i] = None
                    self._watermark[i] = (now, tokens)
            else:
                self._watermark[i] = None
                self._rate[i] = None
                self._stall_since[i] = None
            ewma = float(st.get("step_ewma_s", 0.0))
            ewma_slow = (busy and median is not None and len(ewmas) >= 2
                         and ewma > self.slow_replica_factor * median)
            # rate agreement: a fleet-comparable emission rate VETOES
            # the latency signal (longer steps are honest when the
            # replica carries more slots / prefill chunks / host
            # contention). With fewer than two live samples there is
            # no reference — stay permissive and let the EWMA decide
            rate_poor = (len(rates) < 2 or self._rate[i] is None
                         or median_rate <= 0.0
                         or self._rate[i]
                         < median_rate / self.slow_replica_factor)
            if (ewma_slow and rate_poor) or stalled:
                if self._slow_since[i] is None:
                    self._slow_since[i] = now
                if now - self._slow_since[i] >= self.slow_min_duration_s \
                        or stalled:
                    self._demote_locked(i)
            else:
                self._slow_since[i] = None

    def _demote_locked(self, i: int):  # holds: _cond
        """Demote a gray replica: hedge its open requests to survivors
        (token-level resume — decode steps already spent are never
        re-spent), tell it to CANCEL the hedged work, keep it alive
        and warm, and start probing. Never demote the last live
        replica: slow beats dead."""
        survivors = [j for j in range(self.max_replicas)
                     if j != i and self._state[j] == _LIVE]
        if not survivors:
            self._slow_since[i] = None  # re-judged when the fleet heals
            return
        rep = self._replicas[i]
        self._state[i] = _DEMOTED
        self.demotions += 1
        self._summaries[i] = set()  # don't route by a parked pool
        self._slow_since[i] = None
        self._watermark[i] = None
        self._rate[i] = None
        self._stall_since[i] = None
        self._inbox[i].clear()
        # every open request the journal assigns here is hedged away;
        # the replica cancels them at its next handshake, and the
        # journal assignment fence refuses anything it still reports
        self._cancels[i].update(self._in_flight[i].keys())
        lost = self._journal.lost(rep.name, rep.incarnation)
        self._cancels[i].update(rid for rid, _s, _g, _t in lost)
        self._in_flight[i].clear()
        self._resubmit_lost(i, rep, lost=lost)
        # an outstanding canary would be cancelled with the
        # hedged work and never complete — release it so the restored
        # replica's sweep can send a fresh one
        self._drop_canary_locked(i)
        self._taint_base[i] = {}
        self._canary_mark[i] = {}
        self._probe_ok[i] = 0
        self._probe_at[i] = time.monotonic() + self.probe_interval_s
        self._cond.notify_all()

    def _send_probe_locked(self, i: int):  # holds: _cond
        """Ship a tiny internal generate request to a DEMOTED replica:
        its completion (and the step-latency EWMA that rides the same
        handshake) is the restore evidence. Probes use negative rids,
        are never journaled, and never touch the open-request set."""
        rid = self._next_probe_rid
        self._next_probe_rid -= 1
        prompt = np.zeros(1, np.int32)
        # the probe must pass THIS replica's engine admission rules:
        # a probe refused at admission is a failed probe, and sizing
        # from the base kw (or a hardcoded size) would permanently
        # fail on a replica whose engine_kw_for override shrinks the
        # context/pool below the fleet-wide default
        rep = self._replicas[i]
        L, bt, pb = self._limits_for(
            rep._engine_kw if rep is not None else self._engine_kw)
        max_new = max(1, min(6, L - 1, bt * pb - 1))
        spec = {"prompt": [0], "max_new_tokens": max_new,
                "temperature": 0.0,
                "eos_id": None, "seed": 0, "publish_len": 0,
                "slo": None, "deadline_s": None, "submit_unix": time.time()}
        h = FleetHandle(rid, prompt, spec, None, fleet=self)
        h._probe = True
        self._handles[rid] = h
        self._probes[i] = h
        self.probes_sent += 1
        self._inbox[i].append(h)
        self._cond.notify_all()

    def _probe_done(self, rep: _Replica, completed_ok: bool):  # holds: _cond
        """A probe came back: restore the replica if its step EWMA is
        back inside the healthy band (vs the live-fleet median), else
        schedule the next probe. `probe_ok_needed` consecutive healthy
        probes gate the restore (hysteresis on the way back too)."""
        i = rep.index
        h = self._probes[i]
        if h is None or self._replicas[i] is not rep \
                or self._state[i] != _DEMOTED:
            return
        self._probes[i] = None
        self._handles.pop(h.rid, None)
        h._event.set()  # nobody waits, but keep the future honest
        st = self._rep_stats[i] or {}
        ewma = float(st.get("step_ewma_s", 0.0))
        median = _lower_median(self._live_ewmas())
        healthy = completed_ok and (
            median is None  # no live peer to compare against: restore
            or ewma <= self.slow_replica_factor * median)
        if healthy:
            self._probe_ok[i] += 1
            if self._probe_ok[i] >= self.probe_ok_needed:
                # restored: SAME incarnation, engine + prefix pool warm
                self._state[i] = _LIVE
                self.restores += 1
                self._probe_ok[i] = 0
                self._beats[i] = time.monotonic()
                # demotion cleared the routing summary; the pool is
                # warm and UNCHANGED, so the replica's revision cache
                # would never resend it — ask for a refresh or the
                # warm-restore benefit is silently lost to routing
                self._want_summary[i] = True
                self._cond.notify_all()
                return
        else:
            self._probe_ok[i] = 0
        self._probe_at[i] = time.monotonic() + self.probe_interval_s

    # -- serving integrity ------------------------------------
    def _golden_for(self, weights_version) -> Optional[List[int]]:  # holds: _cond
        """The golden canary trace for one weight version (computed at
        construction / rollout commit), or the explicit default."""
        g = self._canary_golden.get(
            weights_version if weights_version is None
            else int(weights_version))
        return g if g is not None else self._canary_golden_default

    def _drop_canary_locked(self, i: int):  # holds: _cond
        """Release slot i's outstanding canary handle (the replica is
        leaving LIVE service — death, demotion, drain, refill, close —
        so the canary's completion can no longer be judged fairly)."""
        ch = self._canaries[i]
        if ch is not None:
            self._handles.pop(ch.rid, None)
            for fl in self._in_flight:
                fl.pop(ch.rid, None)
            ch._event.set()
            self._canaries[i] = None
        if self.canary_interval_s is not None:
            self._canary_at[i] = time.monotonic() + self.canary_interval_s

    def _canary_sweep(self, now: float):  # thread: monitor, holds: _cond
        """Ship one known-answer canary per LIVE replica every
        `canary_interval_s` (the probe machinery extended past
        demoted-only): a tiny greedy request whose completion is
        judged against the per-weights_version golden trace. Sized
        like probes — within the REPLICA's own composed engine limits,
        so an engine_kw_for override can never wedge a canary at
        admission."""
        for i in range(self.max_replicas):
            if self._state[i] != _LIVE or self._canaries[i] is not None:
                continue
            if now < self._canary_at[i]:
                continue
            rep = self._replicas[i]
            golden = self._golden_for(rep.weights_version)
            if golden is None:
                # no golden for this version (mid-rollout window):
                # skip this round, never guess
                self._canary_at[i] = now + self.canary_interval_s
                continue
            L, bt, pb = self._limits_for(rep._engine_kw)
            P0 = len(self._canary_prompt)
            max_new = min(len(golden), L - P0, bt * pb - P0)
            if max_new < 1:
                self._canary_at[i] = now + self.canary_interval_s
                continue
            rid = self._next_probe_rid
            self._next_probe_rid -= 1
            spec = {"prompt": [int(t) for t in self._canary_prompt],
                    "max_new_tokens": int(max_new), "temperature": 0.0,
                    "eos_id": None, "seed": 0, "publish_len": 0,
                    "slo": None, "deadline_s": None,
                    "submit_unix": time.time()}
            h = FleetHandle(rid,
                            np.asarray(self._canary_prompt, np.int32),
                            spec, None, fleet=self)
            h._probe = True
            h._canary = True
            self._handles[rid] = h
            self._canaries[i] = h
            self.canaries_sent += 1
            self._inbox[i].append(h)
            self._cond.notify_all()

    def _canary_done(self, rep: _Replica, h: FleetHandle, tokens,
                     ok: bool):  # holds: _cond
        """A canary came back: a golden match is the CLEAN mark — every
        token this replica has journaled so far is vouched for, so the
        taint base of its in-flight rids advances to now. A mismatch
        is an integrity trip: quarantine + taint since the last clean
        mark. A fenced (zombie/superseded) completion is evidence of
        nothing and only reschedules."""
        i = rep.index
        if self._canaries[i] is not h or self._replicas[i] is not rep:
            self._handles.pop(h.rid, None)
            h._event.set()
            return  # stale canary: a newer incarnation owns the slot
        self._canaries[i] = None
        self._handles.pop(h.rid, None)
        h._event.set()
        if not ok:
            self._canary_at[i] = time.monotonic() + self.canary_interval_s
            return
        golden = self._golden_for(rep.weights_version) or []
        want = golden[:int(h.spec["max_new_tokens"])]
        if list(tokens) == list(want):
            self.canaries_ok += 1
            # the clean mark: sound because the canary's completion
            # and the progress it vouches for ride the SAME handshake
            # (the replica loop collects both in the iteration of the
            # step that finished the canary — nothing later can be
            # under the mark), and consumed only by canary-KIND trips
            # (engine-global corruption; a canary cannot vouch for
            # another request's KV blocks)
            for rid in self._in_flight[i]:
                if rid >= 0:
                    self._canary_mark[i][rid] = len(
                        self._journal.progress_of(rid))
            self._canary_at[i] = time.monotonic() + self.canary_interval_s
            return
        self.canary_mismatches += 1
        self._integrity_trip_locked(
            i, rep,
            IntegrityError(
                "canary mismatch on %s.i%d: got %r, want %r"
                % (rep.name, rep.incarnation, list(tokens), want),
                kind="canary", replica=rep.name))

    def _integrity_trip_locked(self, i: int, rep: _Replica,
                               exc: BaseException):  # holds: _cond
        """Quarantine a corrupt replica (caller holds `_cond`;
        exactly-once per incarnation): journal the TAINT side-band —
        every open rid assigned here whose journaled progress grew past
        its taint base gets a window [base, now) — which truncates the
        mirror to the verified prefix, then declare the replica dead
        through the normal failover path. The failover's resubmission
        therefore resumes each request from its last VERIFIED token
        index, and the taint window re-decodes on a healthy survivor:
        the one sanctioned exception to the zero-re-decode rule,
        journal-audited (J010) so ONLY tainted tokens ever re-decode.
        The fresh incarnation comes through the supervisor
        backoff exactly like a crash (auto_refill / refill())."""
        if self._replicas[i] is not rep or self._state[i] == _DEAD:
            return  # already quarantined/failed over this incarnation
        self.integrity_trips += 1
        kind = getattr(exc, "kind", "unknown")
        self.integrity_trip_kinds[kind] = \
            self.integrity_trip_kinds.get(kind, 0) + 1
        lost = self._journal.lost(rep.name, rep.incarnation)
        # canary-kind trips may tighten the window to the last clean
        # canary's mark (engine-global corruption is exactly what the
        # canary vouches against); fingerprint/trap/spike trips taint
        # from the assignment base — a clean canary between a KV flip
        # and its detection must NOT launder the flipped block's
        # tokens past the window (review hardening: the canary never
        # attended through that block)
        use_marks = kind == "canary"
        taint: Dict[int, Tuple[int, int]] = {}
        for rid, _spec, _gen, toks in lost:
            base = self._taint_base[i].get(rid, 0)
            if use_marks:
                base = max(base, self._canary_mark[i].get(rid, 0))
            if len(toks) > base:
                taint[rid] = (base, len(toks))
        if taint:
            self.tainted_tokens += sum(u - f for f, u in taint.values())
            # mirror truncation happens HERE (synchronously, like every
            # assign/complete): _fail_over's journal scan an instant
            # later hands the survivor the verified prefix only
            self._pending_journal.append(self._journal.integrity(
                rep.name, rep.incarnation, taint, reason=str(exc),
                defer=True))
            for rid, (frm, _u) in taint.items():
                hh = self._handles.get(rid)
                if hh is not None:
                    hh.emitted = frm
        self._fail_over(i, rep, exc)

    # -- autoscaling ------------------------------------------
    def _window_headroom_s(self) -> float:  # holds: _cond
        """Deadline enforcement granularity: the widest live
        replica's decode window in wall seconds — window size K times
        its PER-TOKEN step EWMA (the gauge is already normalized by
        K). 0.0 for a K=1 fleet, so the pre-window autoscaler behavior
        is untouched."""
        w = 0.0
        for i in range(self.max_replicas):
            rep = self._replicas[i]
            if self._state[i] != _LIVE or rep is None:
                continue
            k = int(rep._engine_kw.get("decode_window") or 1)
            if k <= 1:
                continue
            st = self._rep_stats[i] or {}
            w = max(w, k * float(st.get("step_ewma_s", 0.0)))
        return w

    def _scale_sweep(self, now: float):  # thread: monitor, holds: _cond
        """Queue-driven elasticity: spawn when open requests outrun
        live capacity (or deadline headroom shrinks under real
        queueing), retire after SUSTAINED low load. One cool-down gate
        (`scale_cooldown_s`) serializes both directions — a burst can
        trigger at most one scale op per window, so arrival noise
        cannot flap the fleet (hysteresis on the way down is
        additionally `scale_down_idle_s` of continuous low load).
        Paused during a rollout: drain→swap→refill must not race a
        retirement of the replica being swapped."""
        if self._rollout or self._closing:
            return
        live = [i for i in range(self.max_replicas)
                if self._state[i] == _LIVE]
        n_live = len(live)
        open_n = len(self._open)
        pressure = open_n > self.scale_up_open_per_replica \
            * max(1, n_live)
        if not pressure and self.scale_up_headroom_s is not None \
                and open_n > n_live:
            # deadline pressure counts only under real queueing (more
            # open requests than replicas): a single tight-deadline
            # request on an idle fleet needs routing, not capacity.
            # Headroom is clamped to at least one decode-window's wall
            # time: a decode_window=K engine enforces
            # deadlines every K tokens, so slack thinner than one
            # window is already unservable — spawning for it cannot
            # help, and waiting for it to shrink further would spawn
            # too late for the requests a new replica CAN still serve.
            headroom = max(self.scale_up_headroom_s,
                           self._window_headroom_s())
            for h in self._handles.values():
                if h.deadline_at is not None and not h._probe \
                        and h.deadline_at - now < headroom:
                    pressure = True
                    break
        if pressure:
            self._low_load_since = None
            if now < self._scale_gate_at or n_live >= self.max_replicas:
                return
            self._scale_up_locked(now)
            return
        if n_live > self.min_replicas and open_n < n_live:
            if self._low_load_since is None:
                self._low_load_since = now
            elif now - self._low_load_since >= self.scale_down_idle_s \
                    and now >= self._scale_gate_at:
                victim = self._scale_down_victim_locked(live)
                if victim is not None:
                    self._begin_retire_locked(victim)
                    self._scale_gate_at = now + self.scale_cooldown_s
                    self._low_load_since = None
        else:
            self._low_load_since = None

    def _scale_up_locked(self, now: float):  # holds: _cond
        """Bring one more replica up: a DRAINED slot resumes WARM (the
        refill() machinery's whole point — engine and prefix pool
        intact), else a retired/dead slot spawns a fresh incarnation,
        gated by the slot's supervisor-style restart backoff."""
        for want_warm in (True, False):
            for i in range(self.max_replicas):
                st = self._state[i]
                if want_warm and st == _DRAINED:
                    if self._rollout:
                        # never warm-resume during a rollout: the
                        # parked engine holds pre-rollout weights, and
                        # this slot may be mid-swap (see refill())
                        continue
                    self._state[i] = _LIVE
                    self._beats[i] = time.monotonic()
                    self._kill[i] = False
                elif not want_warm and st in (_RETIRED, _DEAD) \
                        and now >= self._refill_at[i]:
                    self._refill_locked(i)
                else:
                    continue
                self.replicas_spawned += 1
                self._scale_gate_at = now + self.scale_cooldown_s
                self._cond.notify_all()
                return

    def _scale_down_victim_locked(self, live: List[int]):  # holds: _cond
        """Least-loaded live replica whose retirement keeps every
        configured tier represented (retiring the last prefill-capable
        replica would break disaggregation harder than staying one
        replica over target); ties retire the HIGHEST index, keeping
        the low, initially-live slots stable."""
        best, best_key = None, None
        for i in live:
            t = self._replica_tier[i]
            if t is not None and not any(
                    self._replica_tier[j] in (t, None)
                    for j in live if j != i):
                continue
            load = len(self._inbox[i]) + len(self._in_flight[i])
            key = (load, -i)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _begin_retire_locked(self, i: int):  # holds: _cond
        """Graceful scale-down, started (finished by the replica's own
        handshake when it reaches DRAINED with the retire flag set):
        queued requests re-route NOW, in-flight work is hedged to
        survivors FROM THE JOURNAL with token-level resume (the
        demotion mechanism — no decode step re-spent), and the replica
        cancels the clawed-back work at its next handshake, goes idle,
        and retires."""
        self._begin_drain_locked(i, hedge=True, retire=True)

    def _begin_drain_locked(self, i: int, hedge: bool, retire: bool,
                            clear_summary: bool = True):  # holds: _cond
        """Start taking replica `i` out of routing (caller holds
        `_cond`): queued requests re-route now; with `hedge`, in-flight
        work is ALSO clawed back via the journal with token-level
        resume (otherwise it finishes here — the rollout's
        finish-on-old-version policy); with `retire`, the replica's
        own handshake retires the slot once idle instead of parking
        DRAINED. `clear_summary` drops the routing summary (retire and
        rollout: the engine is leaving, its pool must not attract
        traffic); an operator `drain()` keeps it — the pool parks WARM
        and a warm `refill()` must resume with its affinity state
        intact (the replica's revision cache would never resend an
        unchanged pool, the restore bug class)."""
        if self._state[i] != _LIVE:
            return
        rep = self._replicas[i]
        self._retire_flag[i] = retire
        self._state[i] = _DRAINING
        if clear_summary:
            self._summaries[i] = set()
        queued = list(self._inbox[i])
        self._inbox[i].clear()
        for h in queued:
            if h._probe:
                # a canary still in the inbox is released below, never
                # re-routed: routing journals an assign, and a canary
                # (negative rid, never submitted) must not reach the
                # journal (the reference re-routes it: a J001 orphan
                # assign and a J007 open rid in the file)
                continue
            h.generation += 1
            self.resubmitted += 1
            try:
                self._route(h, exclude=i)
            except EngineFailed:
                pass  # no other live replica: handle failed
        if hedge:
            self._cancels[i].update(self._in_flight[i].keys())
            lost = self._journal.lost(rep.name, rep.incarnation)
            self._cancels[i].update(rid for rid, _s, _g, _t in lost)
            self._in_flight[i].clear()
            self._resubmit_lost(i, rep, lost=lost)
            self._taint_base[i] = {}
            self._canary_mark[i] = {}
        self._canary_mark[i] = {}
        # a draining replica's canary would be cancelled (hedge) or
        # park with the engine (finish) — release it either way
        self._drop_canary_locked(i)
        self._cond.notify_all()

    def scale_up(self) -> bool:
        """Operator surface: bring one held-back slot live now (same
        path the autoscaler takes, without its pressure gate). Returns
        whether a slot was available to spawn."""
        with self._cond:
            before = sum(1 for s in self._state if s == _LIVE)
            self._scale_up_locked(time.monotonic())
            started = sum(1 for s in self._state if s == _LIVE) > before
        self._flush_journal()
        return started

    def scale_down(self, i: int) -> bool:
        """Operator surface: gracefully retire replica `i` (drain →
        hedge in-flight from the journal → retire when idle). Returns
        False when the replica is not LIVE. Unlike the autoscaler this
        does not enforce `min_replicas` — the operator asked."""
        with self._cond:
            if self._state[i] != _LIVE:
                return False
            self._begin_retire_locked(i)
        self._flush_journal()
        return True

    # -- operator surface ------------------------------------------------
    def kill_replica(self, i: int):
        """Drill: the replica's next scheduler handshake raises, its
        thread dies, and the normal crash→failover path runs. (The
        subprocess mode SIGKILLs for real via PADDLE_FAULT=kill@N.)"""
        with self._cond:
            self._kill[i] = True
            self._cond.notify_all()

    def busiest_replica(self) -> Optional[int]:
        """The replica holding the most in-flight requests among those
        where one of them has emitted a token (the kill drill's victim:
        killing it fails over started work); None while none has."""
        with self._cond:
            holders = [(len(m), i) for i, m in enumerate(self._in_flight)
                       if any(h.emitted for h in m.values())]
        return max(holders)[1] if holders else None

    def served_weights(self) -> List[Tuple[str, Optional[int], Any]]:
        """(name, weights_version, params) of each replica slot's
        current incarnation: the weights it serves (fixed when the
        incarnation was built: a rollout replaces it, never mutates
        it)."""
        with self._cond:
            return [(rep.name, rep.weights_version,
                     rep.params if rep.params is not None else self._params)
                    for rep in self._replicas]

    def engine_counts(self) -> List[Optional[Dict[str, int]]]:
        """Each replica slot's engine's cumulative `decode_steps` and
        `prefill_chunks` (None for a slot without an engine). A killed
        replica that was not refilled keeps its engine, so its work
        counts. An engine belongs to its replica's thread: call this
        after `close()`."""
        if not self._closing:
            raise RuntimeError("engine_counts() reads the engines, which "
                               "their replica threads own: close the "
                               "fleet first")
        return [None if rep.engine is None else
                {"decode_steps": rep.engine.metrics.decode_steps,
                 "prefill_chunks": rep.engine.metrics.prefill_chunks}
                for rep in self._replicas]

    def drain(self, i: int, wait: bool = False,
              timeout: Optional[float] = None) -> bool:
        """Stop admitting to replica `i`, re-route its queued (not yet
        started) requests, let in-flight work finish and publish its
        prefixes, then park the replica DRAINED (engine and prefix
        pool stay warm for `refill`). With `wait=True`, block until
        drained; returns whether the replica is drained."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            # operator drain: no hedge (in-flight finishes here), no
            # retire, and the routing summary SURVIVES the park (the
            # pool stays warm for refill())
            self._begin_drain_locked(i, hedge=False, retire=False,
                                     clear_summary=False)
        self._flush_journal()  # re-assignments above, before any wait
        with self._cond:
            if not wait:
                return self._state[i] == _DRAINED
            while self._state[i] == _DRAINING:
                t = (None if deadline is None
                     else deadline - time.monotonic())
                if t is not None and t <= 0.0:
                    break
                self._cond.wait(timeout=t if t is not None else 0.5)
            return self._state[i] == _DRAINED

    def refill(self, i: int):
        """Bring replica `i` back: a DRAINED replica resumes with its
        engine (and hot prefix pool) intact; a DEAD or RETIRED one is
        replaced by a fresh incarnation (cold engine, built against
        the fleet's CURRENT weights version) — the restart half of the
        supervisor's restart/backoff story."""
        with self._cond:
            if self._state[i] == _DRAINED:
                if self._rollout:
                    # the warm engine holds PRE-rollout weights — and
                    # this may be the very replica _swap_replica is
                    # draining: reviving it warm would let the swap
                    # loop skip it and leave old weights serving past
                    # a "completed" rollout. A fresh incarnation
                    # builds against the committed new params instead
                    self._refill_locked(i)
                    return
                self._state[i] = _LIVE
                self._beats[i] = time.monotonic()
                self._cond.notify_all()
            elif self._state[i] in (_DEAD, _RETIRED):
                self._refill_locked(i)

    def _refill_locked(self, i: int):
        self._incarnations[i] += 1
        rep = self._make_replica(i, self._incarnations[i])
        self._replicas[i] = rep
        self._state[i] = _LIVE
        self._beats[i] = time.monotonic()
        # a kill_replica() drill aimed at the DEAD predecessor (it
        # crashed before consuming the flag) must not assassinate the
        # fresh incarnation at its first handshake
        self._kill[i] = False
        self._summaries[i] = set()
        self._rep_stats[i] = None
        self._spawned[i] = time.monotonic()
        self._retire_flag[i] = False
        # health/probe state is the PREDECESSOR's verdict, not the
        # fresh incarnation's (the death path cleared it; the rollout
        # swap of a DEMOTED replica comes through here directly)
        self._slow_since[i] = None
        self._watermark[i] = None
        self._rate[i] = None
        self._stall_since[i] = None
        if self._probes[i] is not None:
            self._handles.pop(self._probes[i].rid, None)
            for fl in self._in_flight:
                fl.pop(self._probes[i].rid, None)
            self._probes[i]._event.set()
            self._probes[i] = None
        self._probe_ok[i] = 0
        self._drop_canary_locked(i)
        self._taint_base[i] = {}
        self._canary_mark[i] = {}
        # starting the thread under the lock is safe: its first _sync
        # blocks on the condition until we release. A controlling
        # scheduler learns the name NOW, synchronously (thread_spawning
        # is non-blocking by contract) — the new thread's own
        # registration happens asynchronously, and an unannounced
        # spawn would race the controller's enabled-set snapshots
        if self._hook is not None:
            self._hook.thread_spawning(
                "r%d.i%d" % (i, self._incarnations[i]))
        rep.start()
        self._cond.notify_all()

    # -- live weight rollout ----------------------------------
    def roll_weights(self, ckpt_step=None, params=None, version=None,
                     policy=None, timeout: float = 120.0,
                     canary_golden=None) -> dict:
        """Roll the whole fleet onto a new weight version with zero
        downtime: rolling drain → swap → refill, one replica at a
        time, the rest keep serving throughout. The pserver push/pull
        cycle recast as checkpoint promotion — training saves
        (`save_weights` / `save_checkpoint`), the sentinel promotes a
        known-good step, serving rolls onto it.

        Candidate selection: `ckpt_step` names a step under the
        fleet's `ckpt_dir` — a weight-publish dir written by
        `save_weights` (a raw training save_checkpoint scope is
        refused at load: its entry names are not serving leaf names).
        The default step is the promoted known-good one from
        `<ckpt_dir>/sentinel.json` (write or copy it into the publish
        dir, or pass the step explicitly — e.g.
        `sentinel.known_good_step(training_dir)`). `params=` bypasses
        disk (tests / in-process handoff) with `version=` tagging it
        (default: previous + 1, resolved inside the rollout latch). A disk candidate is
        CRC-verified with `resume_or_init`'s per-step walk machinery
        BEFORE any replica is touched — a failed verify (or a
        leaf-count/shape mismatch at load) raises `RolloutAborted`
        with the fleet untouched: no replica drained, every replica
        still serving the old version.

        Version fence: the fleet's current version is bumped first, so
        every replica spawned from here on serves the NEW weights;
        each swap is a fresh incarnation (never an in-place mutation),
        every assign/done journal record carries the holder's version,
        and the journal DFA's J009 rejects any done whose version
        differs from its latest assignment's. `policy` pins what
        happens to a swapped replica's in-flight requests: "finish"
        (default) lets them complete on the old version (the drain
        waits — a response's tokens all come from one version);
        "migrate" hedges them to survivors from the journal with
        token-level resume (faster swap; the completion records the
        final holder's version). Returns a summary dict.

        Canary fleets: the new version's golden trace is
        computed here for generate()-derivable fleets; an
        explicit-golden fleet (quantized/scripted) must pass the new
        version's known answer via `canary_golden=` — refused
        (RolloutAborted, fleet untouched) otherwise, because judging
        post-rollout canaries against the old answer would quarantine
        healthy replicas in an endless refill loop."""
        policy = policy or self.rollout_policy
        if policy not in ("finish", "migrate"):
            raise ValueError("rollout policy must be 'finish' or "
                             "'migrate', got %r" % (policy,))
        if self.canary_interval_s is not None and not self._canary_auto \
                and canary_golden is None:
            # an explicit-golden fleet (quantized / scripted) cannot
            # have its new version's known answer derived here: without
            # a fresh golden every post-rollout canary would mismatch
            # against the OLD answer and quarantine healthy replicas in
            # an endless refill loop — refuse BEFORE touching anything
            with self._cond:
                self.rollout_aborts += 1
            raise RolloutAborted(
                "this fleet's canaries use an explicit canary_golden "
                "(quantized/scripted engines are not generate()-"
                "derivable): roll_weights needs the NEW version's "
                "golden via canary_golden= — rollout aborted, fleet "
                "untouched")
        if params is not None:
            new_params = params
            # default version (previous + 1) is resolved INSIDE the
            # rollout latch below: reading _weights_version here would
            # let two concurrent roll_weights(params=...) calls both
            # compute the same successor and tag two different weight
            # sets with one version — exactly what the fence forbids
            new_version = None if version is None else int(version)
        else:
            try:
                if self.ckpt_dir is None:
                    raise ValueError(
                        "roll_weights needs the fleet's ckpt_dir knob "
                        "(or explicit params=)")
                step = ckpt_step
                if step is None:
                    from ..distributed.sentinel import known_good_step
                    step = known_good_step(self.ckpt_dir)
                    if step is None:
                        raise RolloutAborted(
                            "no known-good checkpoint step promoted "
                            "under %s — nothing safe to roll to"
                            % self.ckpt_dir)
                from ..distributed.checkpoint import verify_step
                ok, problems = verify_step(self.ckpt_dir, int(step))
                if not ok:
                    raise RolloutAborted(
                        "candidate checkpoint step %d failed "
                        "verification (%s) — rollout aborted, fleet "
                        "untouched" % (int(step), "; ".join(problems)),
                        problems=problems)
                new_params = load_weights(self._params, self.ckpt_dir,
                                          int(step))
            except RolloutAborted:
                with self._cond:
                    self.rollout_aborts += 1
                raise
            new_version = (int(version) if version is not None
                           else int(step))
        with self._cond:
            if self._closing:
                raise RuntimeError("fleet is closed")
            if self._rollout:
                raise RuntimeError("a weight rollout is already in "
                                   "progress")
            self._rollout = True  # pauses the autoscaler too
            old_version = self._weights_version
            if new_version is None:
                new_version = old_version + 1
            # committed FIRST: every refill/spawn from here on builds
            # against the new weights — the rollout can only move
            # forward, a mid-rollout death refills onto the new version
            self._params = new_params
            self._weights_version = new_version
            targets = [i for i in range(self.max_replicas)
                       if self._state[i] in (_LIVE, _DEMOTED,
                                             _DRAINING, _DRAINED)]
        # known-answer canaries: the golden trace is per
        # weights_version, computed at rollout COMMIT — a canary
        # completing on an old-version replica mid-rollout is judged
        # against ITS version's golden (the replica carries the
        # version; _golden_for keys on it), never the new one's.
        # Computed OUTSIDE the lock (a generate() compile must not
        # stall handshakes); explicit-golden fleets passed the new
        # answer in (validated up top — refused otherwise)
        if self.canary_interval_s is not None:
            golden = ([int(t) for t in canary_golden]
                      if canary_golden is not None
                      else golden_trace(new_params, self._cfg,
                                        self._canary_prompt,
                                        self.canary_max_new))
            with self._cond:
                self._canary_golden[int(new_version)] = golden
        try:
            for i in targets:
                self._swap_replica(i, policy, timeout)
        finally:
            with self._cond:
                self._rollout = False
                self._cond.notify_all()
            self._flush_journal()
        with self._cond:
            self.rollouts_completed += 1
        return {"version": new_version, "previous_version": old_version,
                "replicas_swapped": len(targets), "policy": policy}

    def _swap_replica(self, i: int, policy: str, timeout: float):
        """One rolling-swap step: drain replica `i` (policy-dependent:
        wait for in-flight on "finish", hedge it away on "migrate"),
        then replace it with a fresh incarnation built against the
        fleet's new current weights. DEMOTED/DRAINED replicas carry no
        work and swap immediately; a replica that DIES mid-drain is
        refilled the same way (failover already rescued its work)."""
        deadline = time.monotonic() + timeout
        hook = self._hook
        if hook is not None:
            # schedule-exploration seam: the swap of each
            # replica is a yield point, so the explorer can interleave
            # replica handshakes, migrations, and the rollout
            hook.yield_point("rollout:swap:%d" % i)
        with self._cond:
            if self._closing:
                raise RuntimeError(
                    "fleet closed during rollout: replica %d left "
                    "unswapped" % i)
            if self._state[i] == _LIVE:
                self._begin_drain_locked(i, hedge=(policy == "migrate"),
                                         retire=False)
        self._flush_journal()  # re-assignments from the drain begin
        while True:
            with self._cond:
                if self._closing:
                    # close() strands a DRAINING replica (its handshake
                    # stops without transitioning the state, and the
                    # monitor exits): waiting out the timeout here —
                    # or refilling a fresh thread on a closed fleet —
                    # would be worse than the honest error
                    raise RuntimeError(
                        "fleet closed during rollout: replica %d left "
                        "unswapped" % i)
                st = self._state[i]
                if st != _DRAINING:
                    if st in (_DRAINED, _DEMOTED, _DEAD):
                        self._refill_locked(i)
                    break
                t = deadline - time.monotonic()
                if t <= 0.0:
                    raise RuntimeError(
                        "rollout: replica %d failed to drain within "
                        "%.1fs (in-flight work still running on the "
                        "old version; policy='migrate' hedges it away "
                        "instead of waiting)" % (i, timeout))
                if hook is None:
                    self._cond.wait(timeout=min(t, 0.5))
            if hook is not None:
                # park OUTSIDE the lock: a controlled scheduler must be
                # able to run the draining replica's handshakes while
                # the rollout waits (and replay the interleaving)
                hook.yield_point("rollout:wait:%d" % i)
        self._flush_journal()

    def _describe(self, rid: int) -> dict:
        """Operator context for one request (FleetTimeout satellite):
        journal state (queued / assigned / decoding / terminal), the
        replica holding the latest assignment, and tokens emitted."""
        with self._cond:
            emitted = len(self._journal.progress_of(rid))
            a = self._journal.assigned_to(rid)
            replica = a[0] if a else None
            if rid in self._cancelled_rids:
                state = "cancelled"
            elif rid in self._done_rids:
                state = "terminal"
            elif any(h.rid == rid for q in self._inbox for h in q):
                state = "queued"
            elif any(rid in fl for fl in self._in_flight):
                state = "decoding" if emitted else "assigned"
            elif rid in self._open:
                state = "open"
            else:
                state = "unknown"
            rep_state = None
            if a is not None:
                for i, rep in enumerate(self._replicas):
                    if rep.name == a[0]:
                        rep_state = self._state[i]
                        break
            desc = "journal state: %s" % state
            if replica is not None:
                desc += ", assigned to %s (incarnation %d, gen %d%s)" % (
                    a[0], a[1], a[2],
                    "" if rep_state is None else ", replica %s" % rep_state)
            # wire side-band: name the connection
            # and stream cursor so a wire-level FleetTimeout is
            # debuggable from the CLIENT side — which socket owns the
            # stalled request, and how much of the stream it already
            # has (a delivered-vs-journaled gap points at the wire,
            # an emitted-vs-budget gap at the fleet)
            h = self._handles.get(rid)
            conn = None if h is None else h.conn
            streaming = bool(h is not None and h.streaming)
            stream_sent = 0 if h is None else h._stream_sent
            if conn is not None:
                desc += ", wire conn %s" % conn
            if streaming:
                desc += (", streaming (%d of %d journaled token(s) "
                         "delivered)" % (stream_sent, emitted))
            return {"state": state, "replica": replica,
                    "tokens_emitted": emitted, "conn": conn,
                    "streaming": streaming, "stream_sent": stream_sent,
                    "describe": desc}

    def wait_all(self, timeout: Optional[float] = None) -> bool:
        """Block until no request is open (completed, rejected, or
        failed). Returns False on timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while self._open:
                t = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
                if t is not None and t <= 0.0:
                    return False
                self._cond.wait(timeout=t if t is not None else 0.5)
            return True

    def stats(self) -> dict:
        with self._cond:
            base = self._stats_base
            hits = base.get("prefix_hits", 0)
            misses = base.get("prefix_misses", 0)
            saved = base.get("prefix_tokens_saved", 0)
            tokens_out = base.get("tokens_out", 0)
            prefill_tok = base.get("prefill_tokens_computed", 0)
            blocks_in_use = 0  # gauge: live replicas only
            cow = base.get("cow_blocks", 0)
            spec_drafted = base.get("spec_drafted", 0)
            spec_accepted = base.get("spec_accepted", 0)
            ad_hits = base.get("adapter_hits", 0)
            ad_misses = base.get("adapter_misses", 0)
            ad_evictions = base.get("adapter_evictions", 0)
            ad_uploads = base.get("adapter_uploads", 0)
            fp_committed = base.get("fp_committed", 0)
            fp_verified = base.get("fp_verified", 0)
            fp_mismatches = base.get("fp_mismatches", 0)
            # durable-KV counters: same fold discipline
            ho_keys = ("tokens_recomputed_at_migration",
                       "handoff_imports", "handoff_blocks_imported",
                       "handoff_tokens_imported", "handoff_fallbacks",
                       "store_spilled_blocks", "store_warm_blocks",
                       "store_quarantined")
            ho_sums = {k: base.get(k, 0) for k in ho_keys}
            reps = []
            for i, rep in enumerate(self._replicas):
                st = self._rep_stats[i] or {}
                hits += st.get("prefix_hits", 0)
                misses += st.get("prefix_misses", 0)
                saved += st.get("prefix_tokens_saved", 0)
                tokens_out += st.get("tokens_out", 0)
                prefill_tok += st.get("prefill_tokens_computed", 0)
                if self._state[i] == _LIVE:
                    blocks_in_use += st.get("kv_blocks_in_use", 0)
                cow += st.get("cow_blocks", 0)
                spec_drafted += st.get("spec_drafted", 0)
                spec_accepted += st.get("spec_accepted", 0)
                ad_hits += st.get("adapter_hits", 0)
                ad_misses += st.get("adapter_misses", 0)
                ad_evictions += st.get("adapter_evictions", 0)
                ad_uploads += st.get("adapter_uploads", 0)
                fp_committed += st.get("fp_committed", 0)
                fp_verified += st.get("fp_verified", 0)
                fp_mismatches += st.get("fp_mismatches", 0)
                for k in ho_keys:
                    ho_sums[k] += st.get(k, 0)
                reps.append({
                    "name": rep.name, "slo": rep.slo,
                    "tier": rep.tier,
                    "state": self._state[i],
                    "incarnation": rep.incarnation,
                    # gauge: which weight version
                    # this incarnation serves
                    "weights_version": rep.weights_version,
                    # gauge: which paged-attention
                    # kernel this incarnation's compiled steps attend
                    # with (from the engine's own metrics snapshot)
                    "paged_kernel": st.get("paged_kernel"),
                    # gauges: the replica's KV
                    # and weight storage dtypes — uniform across the
                    # fleet by construction (mixed quant is refused at
                    # spawn), surfaced per row as the audit trail
                    "kv_quant": st.get("kv_quant"),
                    "weight_quant": st.get("weight_quant"),
                    "load": len(self._inbox[i]) + len(self._in_flight[i]),
                    "stats": st,
                })
            total = hits + misses
            return {
                "submitted": self.submitted,
                "completed": self.completed,
                "shed": self.shed,
                "rejected": self.rejected,
                "expired": self.expired,
                "expired_on_arrival": self.expired_on_arrival,
                "quota_shed": self.quota_shed,
                "batch_jobs_completed": self.batch_jobs_completed,
                "wfq_depth": 0 if self._wfq is None else len(self._wfq),
                "resubmitted": self.resubmitted,
                "failovers": self.failovers,
                "zombie_refused": self.zombie_refused,
                "duplicate_refused": self.duplicate_refused,
                "demotions": self.demotions,
                "restores": self.restores,
                "probes_sent": self.probes_sent,
                "resumed_requests": self.resumed_requests,
                "resumed_tokens": self.resumed_tokens,
                # elastic lifecycle: fleet-scope monotonic
                # counters (they never fold or reset — a retired
                # replica's history is already in _stats_base)
                "replicas_spawned": self.replicas_spawned,
                "replicas_retired": self.replicas_retired,
                "migrations": self.migrations,
                "rollouts_completed": self.rollouts_completed,
                "rollout_aborts": self.rollout_aborts,
                # serving-integrity counters
                "integrity_trips": self.integrity_trips,
                "integrity_trip_kinds": dict(self.integrity_trip_kinds),
                "canaries_sent": self.canaries_sent,
                "canaries_ok": self.canaries_ok,
                "canary_mismatches": self.canary_mismatches,
                "tainted_tokens": self.tainted_tokens,
                "fp_committed": fp_committed,
                "fp_verified": fp_verified,
                "fp_mismatches": fp_mismatches,
                # durable-KV tier: fleet-scope package
                # counters plus the per-replica sums folded above; the
                # shared store reports its own record/byte counters
                "handoff_packages": self.handoff_packages,
                "handoff_fallbacks_defaulted":
                    self.handoff_fallbacks_defaulted,
                "tokens_recomputed_at_migration":
                    ho_sums["tokens_recomputed_at_migration"],
                "handoff_imports": ho_sums["handoff_imports"],
                "handoff_blocks_imported":
                    ho_sums["handoff_blocks_imported"],
                "handoff_tokens_imported":
                    ho_sums["handoff_tokens_imported"],
                "handoff_fallbacks": ho_sums["handoff_fallbacks"],
                "store_spilled_blocks": ho_sums["store_spilled_blocks"],
                "store_warm_blocks": ho_sums["store_warm_blocks"],
                "store_quarantined": ho_sums["store_quarantined"],
                "kv_store": (None if self.kv_store is None
                             else self.kv_store.stats()),
                "weights_version": self._weights_version,
                "replicas_live": sum(
                    1 for s in self._state if s == _LIVE),
                "open": len(self._open),
                # client cancels are terminal verdicts too:
                # folded in so lost==0 stays the exactly-once bar
                # under disconnect drills
                "cancelled": self.cancelled,
                "cancel_late_refused": self.cancel_late_refused,
                "lost": self.submitted - self.completed - self.rejected
                - self.expired - self.cancelled - len(self._open),
                "tokens_out": tokens_out,
                "prefill_tokens_computed": prefill_tok,
                "prefix_hit_rate": round(hits / total, 4) if total else None,
                "prefix_tokens_saved": saved,
                "kv_blocks_in_use": blocks_in_use,
                "cow_blocks": cow,
                "spec_drafted": spec_drafted,
                "spec_accepted": spec_accepted,
                "spec_accept_rate": round(spec_accepted / spec_drafted, 4)
                if spec_drafted else None,
                "adapter_hits": ad_hits,
                "adapter_misses": ad_misses,
                "adapter_evictions": ad_evictions,
                "adapter_uploads": ad_uploads,
                # per-tenant O(1) metrics: quota buckets,
                # shed counts, completions, tokens served per tenant
                "tenants": (None if self._tenants is None
                            else self._tenants.snapshot()),
                "replicas": reps,
            }

    def close(self, timeout: float = 10.0):
        """Stop every replica and the monitor; fail any still-open
        handle with `EngineFailed` (their waiters must not block on a
        dead fleet) and write it a TERMINAL journal record — the
        journal invariant: after close, every journaled rid
        is done, rejected, or expired; none is ever silently open."""
        with self._cond:
            if self._closing:
                return
            self._closing = True
            for rid in list(self._open):
                h = self._reject_locked(
                    rid, "fleet closed",
                    error=EngineFailed(
                        "fleet closed with request %d pending" % rid,
                        replica=None))
                if h is not None and not h.done:
                    h._event.set()  # waiters must not block on a dead fleet
                    # stream iterators must not either: close directly
                    # (idempotent — the deferred close the reject
                    # queued is a no-op at the final flush)
                    h._stream_feed([], True)
            self._open.clear()
            if self._wfq is not None:
                # queued-but-undispatched entries: their rids were in
                # _open, so the sweep above already rejected them —
                # drop the stale heap entries
                self._wfq.clear()
            for i, ph in enumerate(self._probes):
                if ph is not None:  # outstanding probes die unjournaled
                    self._handles.pop(ph.rid, None)
                    ph._event.set()
                    self._probes[i] = None
            for i, ch in enumerate(self._canaries):
                if ch is not None:  # outstanding canaries likewise
                    self._handles.pop(ch.rid, None)
                    ch._event.set()
                    self._canaries[i] = None
            self._cond.notify_all()
        self._monitor.join(timeout=timeout)
        for rep in list(self._replicas):
            # a held-back slot's replica thread may never have started
            if rep.thread.ident is not None:
                rep.thread.join(timeout=timeout)
        self._flush_journal()  # stragglers from the final syncs
        self._journal.close()
        if self._kv_store_owned and self.kv_store is not None:
            # a store the fleet BUILT (kv_store_dir/kv_store_bytes
            # knobs) closes with the fleet; a caller-provided store is
            # the caller's to close — it may warm the next fleet
            self.kv_store.close()
        # opt-in self-audit: replay the journal file through
        # the protocol DFA so every fleet test / bench run that sets
        # the env var double-checks its own history for free. A journal
        # this fleet OPENED pre-existing keeps its predecessor's open
        # rids (a restarted front door resubmits them under new rids),
        # so only a journal born in this process asserts the
        # everything-terminal close() invariant
        if self._journal.path and os.environ.get(
                "PADDLE_TPU_AUDIT_JOURNAL") == "1":
            from ..analysis.protocol_lint import (JournalViolation,
                                                  verify_journal)
            diags = verify_journal(
                self._journal.path,
                expect_closed=not self._journal.preexisting)
            if diags:
                raise JournalViolation(self._journal.path, diags)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# subprocess mode: real-process kill drills through the control plane
# ---------------------------------------------------------------------------

def run_fleet_subprocess(argv_for, worker_ids, requests,
                         lease_timeout_s=15.0, heartbeat_timeout_s=15.0,
                         env_for=None, deadline_s=240.0,
                         supervisor_kw=None):
    """Serve `requests` (journal-form spec dicts) through N worker
    SUBPROCESSES (tests/torch_fleet_worker.py is the port's worker): the
    requests become Coordinator task leases, the workers run a real
    `ServingEngine` each (`step()` ticks PADDLE_FAULT, so `kill@N`
    SIGKILLs mid-decode), and `distributed/supervisor.py` restarts
    casualties. Fault tolerance is the coordinator's own story: a dead
    worker's leases time out and requeue to survivors (no request
    lost), lease GENERATIONS fence a zombie's late `task_finished` (no
    request acked twice), and results are written atomically per rid.

    `argv_for(worker_id, coordinator_address)` builds one worker's
    command line; result files land wherever the caller's argv points
    the workers. Returns {"report": supervisor report, "coordinator":
    queue counts} — `coordinator["done"] == len(requests)` with
    `discarded == 0` is the no-lost-request check, and lease fencing
    means each rid was acked exactly once.
    """
    from ..distributed.coordinator import Coordinator, CoordinatorServer
    from ..distributed.supervisor import Supervisor

    coord = Coordinator(timeout_s=lease_timeout_s, failure_max=10,
                        heartbeat_timeout_s=heartbeat_timeout_s)
    coord.set_dataset([dict(spec, rid=i)
                       for i, spec in enumerate(requests)])
    server = CoordinatorServer(coord).start()
    try:
        sup = Supervisor(
            lambda wid: argv_for(wid, server.address), worker_ids,
            env_for=env_for, coordinator=coord,
            **(supervisor_kw or {}))
        report = sup.run(deadline_s=deadline_s)
    finally:
        server.stop()
    return {
        "report": report,
        "coordinator": {
            "done": len(coord.done), "todo": len(coord.todo),
            "pending": len(coord.pending),
            "discarded": len(coord.discarded),
        },
    }
