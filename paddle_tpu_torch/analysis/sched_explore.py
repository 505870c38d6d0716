"""Deterministic schedule explorer for the serving fleet (CHESS-lite;
counterpart of paddle_tpu/analysis/sched_explore.py, engine 2 of 2 —
protocol_lint.py is the other). The port's fleet takes the same
decisions as the JAX package's under every schedule: the scenarios,
the scripted engine and the decision policy are the same, so a
schedule replays in either package to the same verdicts and journal.

Every protocol bug that review found by hand was an
INTERLEAVING: a replica handshake racing a demotion racing a close.
Lexical linters cannot see interleavings; systematic concurrency
testing can (Musuvathi et al., "Finding and Reproducing Heisenbugs in
Concurrent Programs"). This module is that idea cut down to this
fleet's seam:

  * The fleet's `SchedulerHook` (serving/fleet.py) marks every
    thread-handoff point — replica handshake, engine step, monitor
    sweep, journal flush, submit commit — all OUTSIDE fleet locks.
    `ControlledScheduler` parks each fleet thread there and runs
    exactly ONE thread at a time; the controller picks who goes next.
  * Scenarios (`SCENARIOS`) build a small fleet over `ScriptEngine` —
    a host-only, deterministic fake engine (one token per step, a pure
    function of (prompt, seed, index), honest `resume_tokens`
    semantics) — so a whole run takes milliseconds and every branch
    the fleet takes is a function of the SCHEDULE alone: heartbeats
    are sized out, deadlines unset, demotion is operator-driven.
  * A schedule is the sequence of choices the controller made (one name
    per step). `run_schedule(scenario, decisions)` replays a decision
    prefix then falls back to the default policy; the same prefix
    always reproduces the same trace, so a violation PRINTS the exact
    schedule that breaks and `--replay` re-runs it.
  * `explore(scenario)` enumerates schedules with bounded preemptions
    (CHESS's insight: most heisenbugs need very few): run the default
    schedule, then branch every choice point where more than one
    thread was enabled, up to `max_preemptions` deviations.

Invariant probes checked after every run (the fleet's falsifiability
bar, machine-checked): every handle reaches a verdict and completed
outputs are token-identical to the scripted oracle; `stats()["lost"]
== 0`; no request is answered twice; the journal file passes the
protocol DFA (`protocol_lint.verify_journal`, close-invariant
included) and its mirror agrees with the file (`recover()` finds
nothing open).

The port keeps no CLI: call `run_schedule` and `explore` (the JAX
package's `python -m paddle_tpu.analysis explore` is its own).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..serving.fleet import SchedulerHook, ServingFleet

__all__ = [
    "ControlledScheduler", "ScriptEngine", "Scenario", "SCENARIOS",
    "RunResult", "run_schedule", "explore", "format_schedule",
    "script_tokens",
]

# one released thread must reach its next yield point (or exit) within
# this budget; past it the run is reported as a WEDGE (the probe-wedge
# bug class), not silently stuck
_QUIESCE_TIMEOUT_S = 20.0


# ---------------------------------------------------------------------------
# scripted engine: the deterministic stand-in for ServingEngine
# ---------------------------------------------------------------------------

def script_tokens(prompt, seed: int, n: int) -> List[int]:
    """The scripted oracle: token i of a request is a pure function of
    (prompt, seed, i) — like the real engine's (seed, token index)
    sampling keys, the schedule/replica/resume split can never change
    WHICH tokens a request decodes to, only who emits them."""
    base = int(np.asarray(prompt, np.int64).sum()) % 1000
    return [(base * 7 + int(seed) * 13 + i * 3) % 97 for i in range(n)]


class _ScriptHandle(object):
    """Matches the real ServingHandle's resume contract: `tokens`
    holds only NEWLY generated tokens (the fleet prepends the resume
    prefix itself at completion), and generation continues at token
    index `len(resume)` of the per-request script."""

    def __init__(self, prompt, max_new, seed, resume):
        self.rid = -1  # assigned by ScriptEngine.submit
        self.tokens: List[int] = []
        self._script = script_tokens(prompt, seed, int(max_new))
        self._at = len(resume)
        if list(resume) != self._script[:self._at]:
            # an honest engine decodes the remainder AFTER the resume
            # prefix; a prefix that disagrees with the script would let
            # a protocol bug hide behind engine nondeterminism
            raise AssertionError(
                "resume prefix %r disagrees with the script %r"
                % (list(resume), self._script))
        self.done = self._at >= len(self._script)
        self.finish_reason = "done" if self.done else None

    def _step(self):
        if self.done:
            return
        self.tokens.append(self._script[self._at])
        self._at += 1
        if self._at >= len(self._script):
            self.done = True
            self.finish_reason = "done"


class _ScriptMetrics(object):
    """The metric surface `_Replica._stats` reads, scripted."""

    def __init__(self, step_ewma_s):
        self.tokens_out = 0
        self.decode_steps = 0
        self.prefills = 0
        self.prefill_tokens_computed = 0
        self.kv_blocks_in_use = 0
        self.kv_blocks_freed_at_retire = 0
        self.kv_tail_blocks_freed = 0
        self.cow_blocks = 0
        self.spec_drafted = 0
        self.spec_accepted = 0
        self.expired = 0
        self.resumed_requests = 0
        self.resume_tokens_reused = 0
        self.step_ewma_s = step_ewma_s
        self.adapter_pool = None


class ScriptEngine(object):
    """Host-only deterministic engine for schedule exploration: one
    token per `step()` per live request, tokens a pure function of
    (prompt, seed, index), honest `resume_tokens` (the remainder is
    decoded from the resume index, never re-decoded), `cancel()` claws
    work back. No model, no wall-clock dependence — a fleet over this
    engine is a pure function of the schedule."""

    def __init__(self, params, cfg, replica_id=None, scheduler_hook=None,
                 step_ewma_s=0.001, **_kw):
        self.replica_id = replica_id
        self._hook = scheduler_hook
        self._serving: Dict[int, _ScriptHandle] = {}
        self._aborted: Optional[BaseException] = None
        self.metrics = _ScriptMetrics(step_ewma_s)
        self.prefix_cache = None

    def submit(self, prompt, max_new_tokens, temperature=0.0,
               eos_id=None, seed=0, publish_len=None, deadline_at=None,
               resume_tokens=None, handoff=None):
        # `handoff`: a block package the fleet ships at
        # re-route. A scripted engine has no KV pool to import into,
        # so the package is dropped on the floor and no outcome is
        # reported — exactly the surface-less engine the fleet's
        # _accept covers with the defaulted fallback outcome (the J011
        # fence the kv_handoff_race scenario explores)
        h = _ScriptHandle(prompt, max_new_tokens, seed,
                          resume_tokens or [])
        if resume_tokens:
            self.metrics.resumed_requests += 1
            self.metrics.resume_tokens_reused += len(resume_tokens)
        # fresh engine-local id (the fleet keeps its own rid map; ours
        # only needs cancel() to find the slot)
        h.rid = max(self._serving, default=-1) + 1
        self._serving[h.rid] = h
        return h

    def step(self):
        if self._hook is not None:
            self._hook.yield_point(
                "engine:%s:step" % (self.replica_id or ""))
        if self._aborted is not None:
            raise self._aborted
        for h in list(self._serving.values()):
            h._step()
            self.metrics.tokens_out += 1
            if h.done:
                self._serving.pop(h.rid)
        self.metrics.decode_steps += 1
        return bool(self._serving)

    def cancel(self, rid) -> bool:
        return self._serving.pop(rid, None) is not None

    def abort(self, exc: BaseException):
        self._aborted = exc
        self._serving.clear()

    @property
    def live_slots(self) -> int:
        return len(self._serving)

    @property
    def queue_depth(self) -> int:
        return 0

    @property
    def prefilling_slots(self) -> int:
        return 0


# ---------------------------------------------------------------------------
# the controlled scheduler
# ---------------------------------------------------------------------------

class SchedulerWedge(RuntimeError):
    """A released thread failed to reach its next yield point (or
    exit) within the quiescence budget — the wedge bug class."""


class ControlledScheduler(SchedulerHook):
    """One-thread-at-a-time cooperative scheduler over the fleet's
    `SchedulerHook` seam. Registered threads (the fleet's replicas and
    monitor, plus scenario threads spawned via `spawn()`) park at
    every yield point until `step(name)` releases them for exactly one
    hop; unregistered threads (the controller's) pass through untouched.
    `release_all()` opens the gate permanently (teardown:
    `fleet.close()` joins threads, which must then free-run)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._names: Dict[int, str] = {}      # guarded-by: _cv
        self._parked: Dict[str, str] = {}     # name -> point; guarded-by: _cv
        self._exited: set = set()             # guarded-by: _cv
        self._free = False                    # guarded-by: _cv
        self._threads: Dict[str, threading.Thread] = {}  # guarded-by: _cv
        # append-only registration log + announced-but-unregistered
        # spawns: step() uses both to wait for threads the RELEASED
        # hop itself spawned (an autoscaler scale-up, a rollout
        # refill) to reach their first park — the recorded enabled-set
        # must not race a fresh thread's startup, or replays of the
        # same schedule could diverge. The fleet announces each spawn
        # SYNCHRONOUSLY via thread_spawning(name) before start(), so
        # even a thread the OS has not scheduled yet (no
        # thread_started call) is accounted for.
        self._reg_log: List[str] = []         # guarded-by: _cv
        self._pending_spawn: set = set()      # guarded-by: _cv

    # -- SchedulerHook (called from fleet threads) ---------------------
    def thread_started(self, kind: str, name: str):
        with self._cv:
            self._names[threading.get_ident()] = name
            self._threads[name] = threading.current_thread()
            self._reg_log.append(name)
            self._pending_spawn.discard(name)
            self._cv.notify_all()

    def thread_spawning(self, name: str):
        # called on the SPAWNING thread (possibly under fleet locks):
        # record only, never block
        with self._cv:
            if not self._free:
                self._pending_spawn.add(name)
            self._cv.notify_all()

    def thread_exiting(self):
        with self._cv:
            name = self._names.pop(threading.get_ident(), None)
            if name is not None:
                self._exited.add(name)
                self._parked.pop(name, None)
                self._cv.notify_all()

    def yield_point(self, point: str):
        with self._cv:
            if self._free:
                return
            name = self._names.get(threading.get_ident())
            if name is None:
                return  # unregistered (controller) thread: pass through
            self._parked[name] = point
            self._cv.notify_all()
            while name in self._parked and not self._free:
                self._cv.wait(timeout=0.5)

    # -- controller surface --------------------------------------------
    def spawn(self, name: str, fn: Callable[[], None]) -> threading.Thread:
        """Run `fn` on a REGISTERED scenario thread: it parks once at
        "scenario:<name>:start" before `fn` begins, then at every
        fleet yield point it hits, like any fleet thread. Blocks until
        that first park (or exit) — returning earlier would let the
        controller's next enabled() RACE the registration, making the
        recorded schedule timing-dependent and breaking replay."""
        def body():
            self.thread_started("scenario", name)
            try:
                self.yield_point("scenario:%s:start" % name)
                fn()
            finally:
                self.thread_exiting()
        t = threading.Thread(target=body, name="sched-%s" % name,
                             daemon=True)
        t.start()
        deadline = time.monotonic() + _QUIESCE_TIMEOUT_S
        with self._cv:
            while (name not in self._parked and name not in self._exited
                   and not self._free):
                if time.monotonic() > deadline:
                    raise SchedulerWedge(
                        "spawned thread %r failed to reach its start "
                        "park" % name)
                self._cv.wait(timeout=0.05)
        return t

    def await_quiescent(self, expected: Optional[int] = None,
                        timeout: float = _QUIESCE_TIMEOUT_S):
        """Block until every registered, live thread is parked (and,
        with `expected`, until at least that many threads exist)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                live = [n for n in self._names.values()]
                ok = all(n in self._parked for n in live)
                if ok and (expected is None
                           or len(live) + len(self._exited) >= expected):
                    return
                if time.monotonic() > deadline:
                    raise SchedulerWedge(
                        "threads failed to quiesce: live=%r parked=%r"
                        % (sorted(live), sorted(self._parked)))
                self._cv.wait(timeout=0.05)

    def enabled(self) -> List[str]:
        with self._cv:
            return sorted(self._parked)

    def parked_point(self, name: str) -> Optional[str]:
        with self._cv:
            return self._parked.get(name)

    def step(self, name: str, timeout: float = _QUIESCE_TIMEOUT_S):
        """Release thread `name` for one hop; block until it parks at
        its next yield point or exits — AND until any thread the hop
        spawned (scale-up, rollout refill) reaches its own first park,
        so the next enabled() snapshot is a pure function of the
        schedule, not of thread-startup timing."""
        with self._cv:
            if name not in self._parked:
                raise KeyError("thread %r is not parked" % name)
            reg0 = len(self._reg_log)
            self._parked.pop(name)
            self._cv.notify_all()
            deadline = time.monotonic() + timeout
            while (name in self._names.values()
                   and name not in self._parked
                   and name not in self._exited):
                if time.monotonic() > deadline:
                    raise SchedulerWedge(
                        "released thread %r failed to park or exit "
                        "within %.0fs (wedged between yield points)"
                        % (name, timeout))
                self._cv.wait(timeout=0.05)
            while not self._free:
                fresh = [n for n in self._reg_log[reg0:]
                         if n in self._names.values()
                         and n not in self._parked
                         and n not in self._exited]
                # announced spawns that have not even registered yet:
                # the synchronous thread_spawning() notice closes the
                # start()-to-registration window
                fresh += [n for n in self._pending_spawn
                          if n not in fresh]
                if not fresh:
                    break
                if time.monotonic() > deadline:
                    raise SchedulerWedge(
                        "thread(s) %r spawned by %r's hop failed to "
                        "reach their first park" % (fresh, name))
                self._cv.wait(timeout=0.05)

    def release_all(self):
        with self._cv:
            self._free = True
            self._parked.clear()
            self._pending_spawn.clear()
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

class _Ctx(object):
    """Per-run scenario context handed to ops and invariant checks."""

    def __init__(self, fleet, sched, journal_path):
        self.fleet = fleet
        self.sched = sched
        self.journal_path = journal_path
        self.handles = []            # (handle, prompt, seed, max_new)
        self.submit_errors: List[BaseException] = []
        self.threads: List[threading.Thread] = []

    def submit(self, prompt, max_new, seed=0, tenant=None,
               stream=False, conn=None):
        h = self.fleet.submit(np.asarray(prompt, np.int32), max_new,
                              seed=seed, slo=None, tenant=tenant,
                              stream=stream, conn=conn)
        self.handles.append((h, list(prompt), seed, max_new))
        return h


class Scenario(object):
    """One explorable fleet scenario: `build()` constructs the fleet
    (ScriptEngine-backed), `ops` is the controller's scripted op list —
    each op is (label, when(ctx) -> bool, run(ctx)) and fires as a
    "main" schedule choice once its precondition holds — and
    `finished(ctx)` ends the controlled phase. Extra invariants beyond
    the common probes go in `check(ctx) -> [violation strings]`."""

    name = "scenario"
    n_replicas = 2
    expect_failures = False  # close-race: EngineFailed verdicts are ok
    expect_cancelled = False  # RequestCancelled verdicts ok

    def fleet_kw(self) -> dict:
        return {}

    def build(self, sched, journal_path) -> _Ctx:
        cfg = type("Cfg", (), {"max_len": 64})()
        params = {"pos": np.zeros((64, 4), np.float32)}
        kw = dict(
            n_replicas=self.n_replicas, journal_path=journal_path,
            heartbeat_timeout_s=3600.0, monitor_interval_s=0.001,
            affinity=False, auto_refill=False,
            engine_factory=ScriptEngine, scheduler_hook=sched,
        )
        kw.update(self.fleet_kw())
        fleet = ServingFleet(params, cfg, **kw)
        # idle replicas sleep this long per handshake with nothing to
        # do; under the controlled scheduler that wall time is pure
        # overhead (the controller serializes everything), so shrink it
        fleet._idle_wait_s = 0.0005
        return _Ctx(fleet, sched, journal_path)

    def ops(self) -> List[Tuple[str, Callable, Callable]]:
        return []

    def finished(self, ctx: _Ctx) -> bool:
        return all(h.done for h, _p, _s, _n in ctx.handles)

    def check(self, ctx: _Ctx) -> List[str]:
        return []


def _always(_ctx):
    return True


class SubmitKillScenario(Scenario):
    """The kill drill as an explored schedule space: two requests, one
    replica killed while (potentially) holding both — journal-driven
    failover must land every request on the survivor with
    token-identical output, whatever the kill lands between."""

    name = "submit_kill"
    n_replicas = 2

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([3, 1, 4], 4, seed=1)),
            ("submit1", _always, lambda c: c.submit([2, 7], 3, seed=2)),
            ("kill_r0", _always, lambda c: c.fleet.kill_replica(0)),
        ]


class DemoteRouteBackScenario(Scenario):
    """The fence-hole window: r0 finishes a request locally but
    has NOT yet reported it; the request is hedged away (demotion),
    the survivor dies, and the request routes BACK to demoted r0 —
    whose next handshake reports the completion of the SUPERSEDED
    submission. The fleet must refuse it (the in-flight fence); the
    `superseded_report` mutant accepts it and double-prepends the
    resume prefix — caught by the token-identity probe and the
    journal DFA's J005."""

    name = "demote_route_back"
    n_replicas = 2

    def _demote_ready(self, ctx):
        # r0 has journaled 2 of 3 tokens AND is parked at its sync
        # yield: token 3 is emitted and the completion is buffered but
        # UNREPORTED — the exact superseded-report window. A deviating
        # schedule can run r0 THROUGH the window (the request
        # completes); the op then fires as a harmless late demotion
        # instead of wedging the op queue
        if not ctx.handles:
            return False
        h = ctx.handles[0][0]
        if h.done:
            return True
        prog = ctx.fleet._journal.progress_of(h.rid)
        parked = ctx.sched.parked_point("r0.i1")
        return len(prog) >= 2 and parked == "replica:r0:sync"

    def _demote(self, ctx):
        with ctx.fleet._cond:
            ctx.fleet._demote_locked(0)

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([5, 9], 3, seed=3)),
            ("demote_r0", self._demote_ready, self._demote),
            ("kill_r1", _always, lambda c: c.fleet.kill_replica(1)),
        ]


class CloseRaceScenario(Scenario):
    """The idempotent-reject window: a submit parks between its
    durable journal write and its routing critical section
    ("submit:commit") while a close() sweeps the open set — both sides
    reach the same rid's terminal bookkeeping, which must happen
    exactly once. The `double_reject` mutant counts it twice and
    drives stats()['lost'] negative."""

    name = "close_race"
    n_replicas = 1
    expect_failures = True

    def _spawn_submitter(self, ctx):
        def body():
            try:
                ctx.submit([1, 2, 3], 3, seed=4)
            except RuntimeError as exc:
                ctx.submit_errors.append(exc)
        ctx.threads.append(ctx.sched.spawn("submitter", body))

    def _spawn_closer(self, ctx):
        def body():
            # short join timeouts: every fleet thread is parked under
            # the controlled scheduler, so the joins MUST time out —
            # deterministically — and close() still finishes its sweep
            ctx.fleet.close(timeout=0.05)
        ctx.threads.append(ctx.sched.spawn("closer", body))

    def _submitter_committed(self, ctx):
        return (ctx.sched.parked_point("submitter") == "submit:commit"
                or "submitter" in ctx.sched._exited)

    def ops(self):
        return [
            ("spawn_submitter", _always, self._spawn_submitter),
            ("spawn_closer", self._submitter_committed,
             self._spawn_closer),
        ]

    def finished(self, ctx):
        return (len(ctx.threads) == 2
                and all(not t.is_alive() for t in ctx.threads))


class ScaleUpMidBurstScenario(Scenario):
    """Elasticity: a burst of three requests hits a
    one-replica fleet whose autoscaler may spawn a second replica at
    any monitor sweep mid-burst. The explored space covers spawns
    landing between submits, between handshakes, and after the burst
    already drained — every request must still reach its oracle
    verdict exactly once, whatever the spawn interleaves with (a
    fresh replica joining routing must not double-route or strand
    inbox work)."""

    name = "scale_up_mid_burst"
    n_replicas = 1

    def fleet_kw(self):
        return {
            "min_replicas": 1, "max_replicas": 2,
            # every monitor sweep with open > live may spawn; no
            # cool-down so the schedule alone decides when
            "scale_up_open_per_replica": 1, "scale_cooldown_s": 0.0,
            "scale_down_idle_s": 1e9,
        }

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([4, 2], 3, seed=5)),
            ("submit1", _always, lambda c: c.submit([8, 1, 6], 4, seed=6)),
            ("submit2", _always, lambda c: c.submit([9], 3, seed=7)),
        ]


class DrainRetireRaceScenario(Scenario):
    """Scale-down: replica r1 is gracefully retired
    (drain → journal-hedge → retire) while it may hold a request whose
    completion is decoded-but-unreported — the retire's clawback races
    the completion handshake. Exactly one verdict per rid must
    survive: the hedged copy resumes from the journaled prefix on r0,
    and r1's superseded report (if its handshake wins the race) must
    be refused by the in-flight fence, not double-answered."""

    name = "drain_retire_race"
    n_replicas = 2

    def _retire_ready(self, ctx):
        # the second submit routes to r1 (least-loaded tie-break);
        # retire once it journaled progress there — the
        # decoded-but-unreported window. A deviating schedule can run
        # the request to completion first; the op then fires as a
        # harmless no-work retirement instead of wedging the op queue
        if len(ctx.handles) < 2:
            return False
        h = ctx.handles[1][0]
        return h.done or len(ctx.fleet._journal.progress_of(h.rid)) >= 1

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([3, 3], 3, seed=8)),
            ("submit1", _always, lambda c: c.submit([7, 5], 3, seed=9)),
            ("retire_r1", self._retire_ready,
             lambda c: c.fleet.scale_down(1)),
        ]

    def check(self, ctx):
        st = ctx.fleet.stats()
        if st["replicas"][1]["state"] not in ("retired", "draining"):
            return ["scale_down(1) never retired r1 (state %r)"
                    % st["replicas"][1]["state"]]
        return []


class RolloutMigrationRaceScenario(Scenario):
    """Live rollout racing a disaggregation migration: a
    tiered fleet (r0 prefill, r1 decode) serves one request — which
    migrates from r0 to r1 at first token — while a `roll_weights`
    (policy "migrate") swaps both replicas under it. The explored
    interleavings land the swap before, between, and after the
    migration's hedge; the probes pin token identity, exactly-once,
    and the journal DFA's J009 version fence (a done record must
    carry its final assignment's weights_version, whichever side of
    the swap completed it)."""

    name = "rollout_migration"
    n_replicas = 2

    def fleet_kw(self):
        return {"replica_tier": ["prefill", "decode"]}

    def _spawn_roller(self, ctx):
        def body():
            ctx.fleet.roll_weights(
                params={"pos": np.zeros((64, 4), np.float32)},
                version=7, policy="migrate")
        ctx.threads.append(ctx.sched.spawn("roller", body))

    def _submitted(self, ctx):
        return bool(ctx.handles)

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([6, 2, 8], 4,
                                                    seed=11)),
            ("spawn_roller", self._submitted, self._spawn_roller),
        ]

    def finished(self, ctx):
        return (all(h.done for h, _p, _s, _n in ctx.handles)
                and len(ctx.threads) == 1
                and not ctx.threads[0].is_alive())

    def check(self, ctx):
        out = []
        st = ctx.fleet.stats()
        if st["weights_version"] != 7:
            out.append("rollout never committed version 7 (%r)"
                       % st["weights_version"])
        if st["rollouts_completed"] != 1:
            out.append("rollouts_completed == %r, expected 1"
                       % st["rollouts_completed"])
        return out


class IntegrityTripScenario(Scenario):
    """Quarantine + taint-aware resume: a tiered fleet (r0
    prefill, r1 decode) serves two requests — a 1-token request whose
    completion handshake the trip can race, and a longer one that
    MIGRATES from r0 to r1 at first token — while an integrity trip
    (the canary-mismatch path, scripted like DemoteRouteBack's
    demotion: canaries themselves are wall-clock-driven, which the
    explorer sizes out) quarantines r0 once it has journaled progress.
    The explored interleavings land the trip before, during, and after
    the migration's hedge and the completion's handshake; the probes
    pin token identity (the taint window re-decodes to the SAME
    tokens on the survivor — the scripted engine is honest), exactly-
    once verdicts, and the journal DFA — now including J010: the
    integrity record's taint windows must be well-formed, re-decoded
    tokens must lie inside them, and nothing may land from the
    quarantined incarnation after its integrity event."""

    name = "integrity_trip"
    n_replicas = 2

    def fleet_kw(self):
        return {"replica_tier": ["prefill", "decode"]}

    def _trip_ready(self, ctx):
        # fire once ANY journaled progress exists (the decoded-but-
        # unreported / mid-migration window); a deviating schedule may
        # have run a request to completion first — the trip then fires
        # as a harmless no-taint quarantine instead of wedging the ops
        if len(ctx.handles) < 2:
            return False
        return any(h.done
                   or len(ctx.fleet._journal.progress_of(h.rid)) >= 1
                   for h, _p, _s, _n in ctx.handles)

    def _trip(self, ctx):
        from ..serving.integrity import IntegrityError

        fleet = ctx.fleet
        with fleet._cond:
            fleet._integrity_trip_locked(
                0, fleet._replicas[0],
                IntegrityError("scripted canary mismatch on r0",
                               kind="canary", replica="r0"))
        fleet._flush_journal()

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([5, 3], 1, seed=31)),
            ("submit1", _always, lambda c: c.submit([2, 8, 4], 4,
                                                    seed=32)),
            ("trip_r0", self._trip_ready, self._trip),
        ]

    def check(self, ctx):
        out = []
        st = ctx.fleet.stats()
        if st["integrity_trips"] != 1:
            out.append("integrity_trips == %r, expected exactly 1 "
                       "(quarantine must be exactly-once)"
                       % st["integrity_trips"])
        if st["replicas"][0]["state"] != "dead":
            out.append("tripped replica r0 not quarantined (state %r)"
                       % st["replicas"][0]["state"])
        return out


class TenantFairnessScenario(Scenario):
    """Multi-tenancy: a burst tenant's three requests race a
    higher-weight SLA tenant's request through the router's new WFQ
    dispatch hop (wfq_window=1 — at most one request is dispatched at
    a time, so the fair queue, not inbox order, decides who runs) on
    a two-replica fleet, with one replica killed mid-burst so the
    failover resubmission path (which BYPASSES the fair queue —
    survival beats fairness) interleaves with WFQ dispatch. The
    probes pin the multi-consumer contract under every explored
    schedule: each tenant's request reaches its oracle verdict
    exactly once (the burst cannot starve the SLA tenant into a lost
    or doubled verdict), per-tenant accounting balances
    (submitted == completed for both), nothing is quota-shed (the
    buckets are sized generously — fairness, not quota, is under
    test), and the journal's typed tenant side-band replays green
    through the DFA."""

    name = "tenant_fairness"
    n_replicas = 2

    def fleet_kw(self):
        from ..serving.tenancy import TenantRegistry

        reg = TenantRegistry()
        # generous buckets: quota never sheds here (determinism under
        # wall-clock-free exploration); the SLA tenant's 4x weight is
        # what the WFQ hop must honor
        reg.add("burst", rate=1000.0, burst=1000.0, weight=1.0,
                slo=None)
        reg.add("sla", rate=1000.0, burst=1000.0, weight=4.0,
                slo=None)
        return {"tenants": reg, "wfq_window": 1}

    def ops(self):
        return [
            ("burst0", _always,
             lambda c: c.submit([4, 4], 3, seed=21, tenant="burst")),
            ("burst1", _always,
             lambda c: c.submit([6, 1], 3, seed=22, tenant="burst")),
            ("sla0", _always,
             lambda c: c.submit([2, 9, 5], 4, seed=23, tenant="sla")),
            ("burst2", _always,
             lambda c: c.submit([8], 3, seed=24, tenant="burst")),
            ("kill_r0", _always, lambda c: c.fleet.kill_replica(0)),
        ]

    def check(self, ctx):
        out = []
        st = ctx.fleet.stats()
        if st["quota_shed"]:
            out.append("quota shed %d request(s) under generous "
                       "buckets" % st["quota_shed"])
        for name, want in (("burst", 3), ("sla", 1)):
            t = (st["tenants"] or {}).get(name, {})
            if t.get("submitted") != want or t.get("completed") != want:
                out.append(
                    "tenant %r accounting off: submitted %r / "
                    "completed %r, expected %d of each"
                    % (name, t.get("submitted"), t.get("completed"),
                       want))
        return out


class KVHandoffRaceScenario(Scenario):
    """Durable-KV handoff under adversarial interleaving: a
    tiered fleet (r0 prefill, r1 decode) shares a pre-seeded
    `KVBlockStore`, so the request's migration at first token attaches
    a checksummed block package to the re-route — while (a) a store
    EVICTION races the package build on the source side (the chain the
    router credited may be gone by the time `chain_fetch` runs: before
    → no package, after → package shipped; both must serve), and (b)
    an integrity TRIP quarantines the decode target r1, so a shipped
    package's holder can die tainted before, during, or after
    accounting for it. The probes pin token identity and exactly-once
    verdicts as ever, plus the journal DFA's new J011 handoff fence:
    every assign that shipped a package must trace to a done carrying
    a verified-import or counted-fallback outcome (the ScriptEngine
    reports none, so every explored path exercises the fleet's
    defaulted-outcome cover), and no done may claim an import its
    assignment never shipped."""

    name = "kv_handoff_race"
    n_replicas = 2

    def fleet_kw(self):
        from ..serving.kv_store import KVBlockStore, make_block_record
        from ..serving.prefix_cache import fold_key

        # pre-seeded store: one fabricated record covering the
        # prompt's single closed block (2, 8). The payload bytes are
        # arbitrary — the ScriptEngine never uploads them — but the
        # crc is honest, so the store serves the record and the fleet
        # genuinely builds and ships a package
        store = KVBlockStore(block_tokens=2)
        self._block_key = fold_key(0, (2, 8))
        store.put(make_block_record(self._block_key, 0, (2, 8), 1.0,
                                    b"scripted-block--", []))
        return {
            "kv_store": store,
            "replica_tier": ["prefill", "decode"],
            "engine_kw": {"prefix_cache_tokens": 64,
                          "kv_block_tokens": 2},
        }

    def _progressed(self, ctx):
        # fire once ANY journaled progress exists — the window where
        # the migration's package build / the target's import race the
        # eviction and the trip; a deviating schedule may have
        # finished the request first, firing the op harmlessly late
        if not ctx.handles:
            return False
        h = ctx.handles[0][0]
        return (h.done
                or len(ctx.fleet._journal.progress_of(h.rid)) >= 1)

    def _evict(self, ctx):
        ctx.fleet.kv_store.evict(self._block_key)

    def _on_target(self, ctx):
        # fire once the migrated copy (package attached) is r1's — or
        # the request already finished: the trip then races r1's
        # accounting for the package it received, not the pre-
        # migration prefill (which the plain integrity_trip scenario
        # already covers)
        if not ctx.handles:
            return False
        h = ctx.handles[0][0]
        if h.done:
            return True
        a = ctx.fleet._journal.assigned_to(h.rid)
        return a is not None and a[0] == "r1"

    def _trip(self, ctx):
        from ..serving.integrity import IntegrityError

        fleet = ctx.fleet
        with fleet._cond:
            fleet._integrity_trip_locked(
                1, fleet._replicas[1],
                IntegrityError("scripted canary mismatch on r1",
                               kind="canary", replica="r1"))
        fleet._flush_journal()

    def ops(self):
        return [
            ("submit0", _always, lambda c: c.submit([2, 8, 4], 4,
                                                    seed=41)),
            ("evict_store", self._progressed, self._evict),
            ("trip_r1", self._on_target, self._trip),
        ]

    def check(self, ctx):
        out = []
        st = ctx.fleet.stats()
        if st["integrity_trips"] != 1:
            out.append("integrity_trips == %r, expected exactly 1"
                       % st["integrity_trips"])
        if st["replicas"][1]["state"] != "dead":
            out.append("tripped replica r1 not quarantined (state %r)"
                       % st["replicas"][1]["state"])
        # the package-accounting fence itself (every shipped package
        # traces to a verified import or a counted fallback) is J011,
        # already replayed by the harness's verify_journal probe —
        # including the superseded-assignment path where a later
        # package-less assign lawfully absorbs the account
        return out


class StreamDisconnectRaceScenario(Scenario):
    """The wire races: two streamed requests; one client
    cancels (a dropped connection's path) while its LAST token's
    completion handshake may already be in flight — the
    cancel-vs-accept race the `_cancelled_rids` fence decides (a late
    completion must count `cancel_late_refused`, never a duplicate or
    a resurrection) — and the OTHER request's holder is killed
    mid-stream, so failover must splice its stream token-exactly (no
    token re-pushed, none skipped: the `_stream_sent` cursor vs the
    resumed journal prefix). The streamed buffers are probed against
    the ScriptEngine oracle; the journal DFA replays the `cancelled`
    terminal and the conn/stream side-bands on every explored
    schedule."""

    name = "stream_disconnect_race"
    n_replicas = 2
    expect_cancelled = True

    def ops(self):
        return [
            ("submit0", _always,
             lambda c: c.submit([3, 1, 4], 4, seed=21, stream=True,
                                conn="c0")),
            ("submit1", _always,
             lambda c: c.submit([2, 7], 6, seed=22, stream=True,
                                conn="c1")),
            ("cancel0", self._near_done0, self._cancel0),
            ("kill_holder1", self._streaming1, self._kill_holder1),
        ]

    def _near_done0(self, ctx):
        # fire once rid0's penultimate token is journaled: the cancel
        # then races the final-token completion handshake. A deviating
        # schedule may complete rid0 first — the cancel fires
        # harmlessly late (fleet.cancel returns False on a done rid)
        if not ctx.handles:
            return False
        h = ctx.handles[0][0]
        return (h.done
                or len(ctx.fleet._journal.progress_of(h.rid)) >= 3)

    def _cancel0(self, ctx):
        ctx.fleet.cancel(ctx.handles[0][0].rid)

    def _streaming1(self, ctx):
        # rid1 is mid-stream: assigned, with at least one journaled
        # token but not all of them (or already done — late kill is a
        # no-op, the harmless-late rule every kill op follows)
        if len(ctx.handles) < 2:
            return False
        h = ctx.handles[1][0]
        return (h.done
                or len(ctx.fleet._journal.progress_of(h.rid)) >= 1)

    def _kill_holder1(self, ctx):
        h = ctx.handles[1][0]
        if h.done:
            return
        a = ctx.fleet._journal.assigned_to(h.rid)
        if a is None:
            return
        ctx.fleet.kill_replica(int(str(a[0])[1:]))

    def check(self, ctx):
        out = []
        for h, prompt, seed, max_new in ctx.handles:
            oracle = script_tokens(prompt, seed, max_new)
            with h._stream_cv:
                buf = list(h._stream_buf)
                closed = h._stream_closed
            if buf != oracle[:len(buf)]:
                out.append(
                    "rid %d streamed prefix diverges from the oracle: "
                    "buf %r vs %r (a failover re-pushed or skipped a "
                    "streamed token)" % (h.rid, buf, oracle))
            if not closed:
                out.append("rid %d stream never closed" % h.rid)
            if h.error is None and buf != oracle:
                out.append(
                    "rid %d completed but streamed only %d of %d "
                    "token(s) — stream != result"
                    % (h.rid, len(buf), len(oracle)))
        st = ctx.fleet.stats()
        if st["cancelled"] == 0 and st["completed"] != len(ctx.handles):
            out.append(
                "no cancel landed yet completed == %d of %d"
                % (st["completed"], len(ctx.handles)))
        if st["duplicate_refused"] != 0:
            out.append(
                "duplicate_refused == %d: a cancelled rid's late "
                "completion was misfiled (cancel_late_refused is the "
                "only lawful bucket)" % st["duplicate_refused"])
        return out


SCENARIOS: Dict[str, Callable[[], Scenario]] = {
    "submit_kill": SubmitKillScenario,
    "demote_route_back": DemoteRouteBackScenario,
    "close_race": CloseRaceScenario,
    "scale_up_mid_burst": ScaleUpMidBurstScenario,
    "drain_retire_race": DrainRetireRaceScenario,
    "rollout_migration": RolloutMigrationRaceScenario,
    "tenant_fairness": TenantFairnessScenario,
    "integrity_trip": IntegrityTripScenario,
    "kv_handoff_race": KVHandoffRaceScenario,
    "stream_disconnect_race": StreamDisconnectRaceScenario,
}


# ---------------------------------------------------------------------------
# driving one schedule
# ---------------------------------------------------------------------------

class RunResult(object):
    def __init__(self, scenario_name, journal_path=None):
        self.scenario = scenario_name
        self.journal_path = journal_path
        self.trace: List[Tuple[Tuple[str, ...], str]] = []
        self.violations: List[str] = []

    @property
    def schedule(self) -> List[str]:
        return [chosen for _enabled, chosen in self.trace]

    def __repr__(self):
        return ("RunResult(%s, %d steps, %s)"
                % (self.scenario, len(self.trace),
                   "OK" if not self.violations
                   else "%d violation(s)" % len(self.violations)))


def format_schedule(schedule: Sequence[str]) -> str:
    return ",".join(schedule)


# how many consecutive hops the default policy lets one thread run
# before rotating: long enough to cover a multi-yield window (a crash
# path is sync-raise -> journal-flush -> exit, three hops), short
# enough that every thread keeps making progress (liveness)
_STICKY_HOPS = 3


def _default_choice(enabled: List[str], last: Optional[str],
                    streak: int) -> str:
    """The deterministic baseline schedule deviations are counted
    against: 'main' first (scenario ops fire as soon as their
    preconditions hold), then STICKY round-robin — continue the thread
    that just ran for up to `_STICKY_HOPS` hops (the CHESS
    non-preemptive baseline, bounded for liveness), then rotate."""
    if "main" in enabled:
        return "main"
    if last in enabled and streak < _STICKY_HOPS:
        return last
    if last in enabled:
        i = enabled.index(last)
        return enabled[(i + 1) % len(enabled)]
    for name in enabled:
        if last is None or name > last:
            return name
    return enabled[0]


def run_schedule(scenario: Scenario, decisions: Sequence[str],
                 journal_path: str,
                 max_steps: int = 400) -> RunResult:
    """Run `scenario` under the controlled scheduler, following
    `decisions` (thread names / "main") while they last and the
    default policy after; record the full trace; check the invariant
    probes. Deterministic: the same decisions always produce the same
    trace and the same verdict."""
    from .diagnostics import format_diag
    from .protocol_lint import verify_journal

    sched = ControlledScheduler()
    result = RunResult(scenario.name, journal_path)
    ctx = scenario.build(sched, journal_path)
    fleet = ctx.fleet
    try:
        sched.await_quiescent(expected=scenario.n_replicas + 1)
        ops = list(scenario.ops())
        op_i = 0
        di = 0
        last = None
        streak = 0
        steps = 0
        while steps < max_steps:
            if op_i >= len(ops) and scenario.finished(ctx):
                break
            enabled = sched.enabled()
            if op_i < len(ops) and ops[op_i][1](ctx):
                enabled = ["main"] + enabled
            if not enabled:
                if op_i >= len(ops):
                    break  # every registered thread exited, nothing left
                result.violations.append(
                    "wedge: op %r blocked with no runnable thread"
                    % (ops[op_i][0],))
                break
            if di < len(decisions):
                choice = decisions[di]
                di += 1
                if choice not in enabled:
                    result.violations.append(
                        "schedule-divergence: decision %d chose %r but "
                        "enabled=%r (replay of a stale schedule?)"
                        % (di - 1, choice, enabled))
                    break
            else:
                choice = _default_choice(enabled, last, streak)
            result.trace.append((tuple(enabled), choice))
            streak = streak + 1 if choice == last else 1
            last = choice
            steps += 1
            if choice == "main":
                label, _when, run = ops[op_i]
                op_i += 1
                run(ctx)
            else:
                sched.step(choice)
        else:
            # the loop ran out of steps — but finishing ON the last
            # step is a finish, not a wedge
            if not (op_i >= len(ops) and scenario.finished(ctx)):
                result.violations.append(
                    "wedge: scenario did not finish within %d "
                    "schedule steps" % max_steps)
    except SchedulerWedge as exc:
        result.violations.append("wedge: %s" % exc)
    finally:
        sched.release_all()
        try:
            fleet.close()
        except Exception as exc:  # audit raises ride the violations
            result.violations.append("close: %r" % exc)
        for t in ctx.threads:
            t.join(timeout=_QUIESCE_TIMEOUT_S)

    # -- invariant probes ------------------------------------------------
    from ..serving.fleet import (EngineFailed, RequestCancelled,
                                 RequestJournal)
    for h, prompt, seed, max_new in ctx.handles:
        if not h.done:
            result.violations.append(
                "rid %d never reached a verdict" % h.rid)
            continue
        if h.error is not None:
            if isinstance(h.error, RequestCancelled):
                # a scripted client-cancel verdict: lawful
                # only where the scenario stages one; its journaled
                # prefix is still probed by the scenario's check()
                # and the DFA's J005 bar on the cancelled record
                if not scenario.expect_cancelled:
                    result.violations.append(
                        "rid %d cancelled but the scenario scripts no "
                        "cancel" % h.rid)
            elif not (scenario.expect_failures
                      and isinstance(h.error, EngineFailed)):
                result.violations.append(
                    "rid %d failed unexpectedly: %r" % (h.rid, h.error))
            continue
        expected = script_tokens(prompt, seed, max_new)
        if list(h.tokens or []) != expected:
            result.violations.append(
                "rid %d token identity violated: got %r, oracle %r "
                "(a stale-incarnation report was accepted?)"
                % (h.rid, h.tokens, expected))
    st = fleet.stats()
    if st["lost"] != 0:
        result.violations.append(
            "stats()['lost'] == %d (submitted %d, completed %d, "
            "rejected %d, expired %d, cancelled %d, open %d)"
            % (st["lost"], st["submitted"], st["completed"],
               st["rejected"], st["expired"], st["cancelled"],
               st["open"]))
    if st["completed"] > len(ctx.handles):
        result.violations.append(
            "completed %d > %d submitted: a request was answered twice"
            % (st["completed"], len(ctx.handles)))
    diags = verify_journal(journal_path, expect_closed=True)
    result.violations.extend(
        "journal: %s" % format_diag(d) for d in diags)
    if RequestJournal.recover(journal_path):
        result.violations.append(
            "journal mirror/file divergence: recover() found open "
            "rids after close()")
    result.violations.extend(scenario.check(ctx))
    return result


# ---------------------------------------------------------------------------
# bounded-preemption enumeration
# ---------------------------------------------------------------------------

class ExploreReport(object):
    def __init__(self, scenario_name):
        self.scenario = scenario_name
        self.runs = 0
        self.violation: Optional[RunResult] = None

    @property
    def ok(self) -> bool:
        return self.violation is None

    def __repr__(self):
        return ("ExploreReport(%s, %d schedules, %s)"
                % (self.scenario, self.runs,
                   "clean" if self.ok else "VIOLATION"))


def explore(scenario_factory: Callable[[], Scenario], tmp_dir: str,
            max_preemptions: int = 1, max_schedules: int = 64,
            max_steps: int = 400) -> ExploreReport:
    """Systematic bounded-preemption sweep: run the default schedule,
    then branch every choice point where another thread was enabled,
    spending at most `max_preemptions` deviations per schedule (the
    CHESS bound), capped at `max_schedules` runs. Stops at the first
    violating schedule — the result carries it, replayable."""
    import os

    scenario = scenario_factory()
    report = ExploreReport(scenario.name)
    seen = set()
    # iterative-deepening order (the CHESS bound made into a search
    # order): exhaust every 1-preemption schedule before any
    # 2-preemption one, and within a level branch LATE choice points
    # first — a heisenbug window sits near the end of the op script
    # far more often than the start
    queue: List[Tuple[Tuple[str, ...], int]] = [((), 0)]
    while queue and report.runs < max_schedules:
        best = min(range(len(queue)),
                   key=lambda i: (queue[i][1], -len(queue[i][0])))
        prefix, n_pre = queue.pop(best)
        jpath = os.path.join(
            tmp_dir, "explore_%s_%04d.jsonl"
            % (scenario.name, report.runs))
        result = run_schedule(scenario_factory(), list(prefix), jpath,
                              max_steps=max_steps)
        report.runs += 1
        if result.violations:
            report.violation = result
            return report
        schedule = result.schedule
        for i in range(len(prefix), len(result.trace)):
            enabled, chosen = result.trace[i]
            for alt in enabled:
                if alt == chosen:
                    continue
                # one deviation = one preemption. The STICKY default
                # policy continues the deviated-to thread afterwards,
                # so a multi-hop window (a crash path is sync-raise ->
                # journal-flush -> exit) is reachable with a single
                # deviation — the CHESS small-bound insight holds
                # without free-continuation bookkeeping.
                if n_pre + 1 > max_preemptions:
                    continue
                branch = tuple(schedule[:i]) + (alt,)
                if branch not in seen:
                    seen.add(branch)
                    queue.append((branch, n_pre + 1))
    return report
