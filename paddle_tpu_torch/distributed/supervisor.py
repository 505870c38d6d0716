"""Elastic job supervisor (counterpart of
paddle_tpu/distributed/supervisor.py): the loop that composes the
coordinator's task leases, the heartbeat membership protocol, and the
CRC-checked elastic checkpoints into actual fault tolerance.

Reference parity: the Go cloud layer's elasticity is split between the
master's lease queue (go/master/service.go) and etcd — trainers announce
themselves under a TTL key, the cluster controller watches those keys
and respawns pods whose keys expire (go/pserver/etcd_client.go:70-150).
Here both halves live in one process tree so the whole story is
testable on one machine: the Coordinator doubles as the membership
registry (heartbeat deadlines instead of etcd TTLs) and this Supervisor
is the controller — it spawns N worker processes, watches exits AND
heartbeat deadlines, and restarts casualties from their latest complete
checkpoint.

Failure taxonomy handled:

  crash/preempt   the process exits nonzero or is signalled -> restart;
                  the worker resumes via checkpoint.resume_or_init and
                  any lease it held times out server-side and requeues
  hang/livelock   the process is alive but stops heartbeating
                  (PADDLE_FAULT=hang@N) -> SIGKILL after the heartbeat
                  deadline passes, then restart as above
  crash loop      `restart_max` consecutive RAPID failures (the process
                  died before living `min_uptime_s`) -> abandon the
                  worker; the job degrades gracefully because the
                  coordinator requeues its shards to the survivors
  divergence      a worker whose training sentinel tripped exits with
                  `sentinel_exit_code` (75, EX_TEMPFAIL): an ORDERLY
                  rollback request, not a crash. It is budgeted
                  separately (`sentinel_rollback_max`, its own
                  exponential backoff) and never feeds
                  `rapid_failures` — divergence churn and crash loops
                  must stay distinguishable to operators
  netsplit        not the supervisor's problem: RemoteCoordinator rides
                  out partitions on exponential backoff

Every death is classified with a restart *reason* (`crash` /
`sentinel_rollback` / `hang`), kept in the handle's `restart_reasons`
audit trail, exported in `summary()`, and handed to the replacement
process as PADDLE_RESTART_REASON — workers put it in their
`register_worker(meta=...)` so the coordinator membership shows WHY
each incarnation exists.

The supervisor never parses worker output and the workers never talk to
the supervisor — liveness flows exclusively through the coordinator
membership, so the same supervisor drives local subprocess trees today
and remote launchers later.
"""

from __future__ import annotations

import os
import signal
import subprocess
import time
from typing import Callable, Dict, List, Optional

from . import checkpoint as _ckpt
from . import sentinel as _sentinel

__all__ = ["Supervisor", "WorkerHandle", "restart_backoff_s"]

_FAULT_ENV = "PADDLE_FAULT"


def restart_backoff_s(consecutive_failures: int, base: float = 0.1,
                      cap: float = 5.0) -> float:
    """The supervisor's exponential restart-backoff schedule as ONE
    shared function: `base * 2**(n-1)` seconds after the n-th
    consecutive rapid failure, capped at `cap`. The serving fleet's
    auto-refill and autoscaler spawn gates reuse it so replica
    respawn discipline cannot silently diverge from worker respawn
    discipline (a deterministically-failing replica must not
    crash/refill at monitor frequency forever, exactly like a
    crash-looping worker)."""
    return min(cap, base * (2 ** max(int(consecutive_failures) - 1, 0)))


class _BlindSpawn(object):
    """Sentinel for WorkerHandle.spawn_incarnation: the process was
    spawned while the membership view was blind (partition / bouncing
    coordinator), so NO baseline snapshot could be taken. It is replaced
    by a real snapshot on the first sweep with a visible view — without
    it, `spawn_incarnation=None` would let the dead predecessor's
    expired record (any incarnation != None) condemn the healthy new
    process the moment the partition heals."""

    def __repr__(self):
        return "<blind-spawn>"


_BLIND_SPAWN = _BlindSpawn()


class WorkerHandle(object):
    """Supervisor-side state for one logical worker id across all of its
    incarnations (process restarts)."""

    def __init__(self, worker_id: str):
        self.worker_id = worker_id
        self.proc: Optional[subprocess.Popen] = None
        self.spawned_at = 0.0
        self.restarts = 0          # successful respawns performed
        self.rapid_failures = 0    # consecutive deaths before min_uptime
        self.hang_kills = 0        # times killed for missed heartbeats
        self.sentinel_rollbacks = 0  # orderly divergence-rollback exits
        self.restart_reasons: List[str] = []  # crash|sentinel_rollback|hang
        self.last_restart_reason: Optional[str] = None
        self.exit_codes: List[int] = []
        self.abandoned = False
        self.done = False          # exited 0; will not be respawned
        self.next_spawn_at = 0.0   # restart backoff gate
        self.member_seen = 0.0     # last time membership showed THIS
                                   # incarnation (0 = never)
        self.spawn_incarnation = None  # membership incarnation present
                                       # when this process was spawned
                                       # (None = no record existed)

    @property
    def running(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    def summary(self) -> dict:
        return {
            "restarts": self.restarts,
            "rapid_failures": self.rapid_failures,
            "hang_kills": self.hang_kills,
            "sentinel_rollbacks": self.sentinel_rollbacks,
            "restart_reasons": list(self.restart_reasons),
            "exit_codes": list(self.exit_codes),
            "abandoned": self.abandoned,
            "done": self.done,
        }


class Supervisor(object):
    """Spawn and babysit `worker_ids` subprocesses.

    Arguments:
      argv_for(worker_id) -> list[str]    command line for one worker
      worker_ids                          logical ids; stable across restarts
      env_for(worker_id) -> dict | None   base env for FIRST launch
                                          (default: inherited os.environ)
      coordinator                         object with membership() — the
                                          in-process Coordinator or a
                                          RemoteCoordinator; None disables
                                          hang detection (exit codes only)
      heartbeat_timeout_s                 the coordinator's heartbeat
                                          deadline, used ONLY as the
                                          detection-lag estimate when
                                          classifying a hang kill as rapid
                                          (liveness itself comes from the
                                          coordinator's own `alive` flag).
                                          Default: read from the
                                          coordinator when it exposes
                                          `heartbeat_timeout_s`, else 30 s
      restart_max                         consecutive rapid failures before
                                          a worker is abandoned
      min_uptime_s                        a death before this uptime counts
                                          as rapid (crash-loop evidence);
                                          surviving longer resets the count
      restart_backoff_s                   base of the exponential restart
                                          delay (doubles per consecutive
                                          rapid failure, capped at 5 s)
      fault_once                          strip PADDLE_FAULT from restart
                                          envs, so an injected fault fires
                                          in one incarnation only
      ckpt_dir_for(worker_id) -> str      when given, retain() is run on the
                                          worker's checkpoint dir after each
                                          restart (crash-loop disk GC). The
                                          sentinel's last known-good step
                                          (read from the dir's
                                          sentinel.json) is always passed
                                          as `protect` — GC can never eat
                                          a rollback target
      ckpt_keep_last                      complete steps retain() keeps
      sentinel_exit_code                  exit code workers use to request
                                          an orderly divergence rollback
                                          (sentinel.SENTINEL_EXIT_CODE);
                                          such deaths are classified
                                          `sentinel_rollback`, budgeted
                                          and backed off separately, and
                                          never count as rapid failures
      sentinel_rollback_max               total sentinel rollbacks before
                                          the worker is abandoned (the
                                          sentinel itself abandons first
                                          when quarantine cannot cure the
                                          divergence; this is the outer
                                          safety net)
    """

    def __init__(self, argv_for: Callable[[str], List[str]],
                 worker_ids, env_for=None, coordinator=None,
                 heartbeat_timeout_s: Optional[float] = None,
                 restart_max: int = 3, min_uptime_s: float = 2.0,
                 restart_backoff_s: float = 0.1,
                 fault_once: bool = True,
                 ckpt_dir_for: Optional[Callable[[str], str]] = None,
                 ckpt_keep_last: int = 2,
                 spawn_grace_s: float = 120.0,
                 poll_s: float = 0.05,
                 membership_deadline_s: float = 2.0,
                 sentinel_exit_code: int = _sentinel.SENTINEL_EXIT_CODE,
                 sentinel_rollback_max: int = 8):
        self.argv_for = argv_for
        self.worker_ids = [str(w) for w in worker_ids]
        self.env_for = env_for
        self.coordinator = coordinator
        if heartbeat_timeout_s is None:
            heartbeat_timeout_s = getattr(
                coordinator, "heartbeat_timeout_s", None
            ) or 30.0
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.restart_max = restart_max
        self.min_uptime_s = min_uptime_s
        self.restart_backoff_s = restart_backoff_s
        self.fault_once = fault_once
        self.ckpt_dir_for = ckpt_dir_for
        self.ckpt_keep_last = ckpt_keep_last
        self.spawn_grace_s = spawn_grace_s
        self.poll_s = poll_s
        self.membership_deadline_s = membership_deadline_s
        self.sentinel_exit_code = int(sentinel_exit_code)
        self.sentinel_rollback_max = int(sentinel_rollback_max)
        # supervision state is single-threaded BY DESIGN (the whole
        # point of the heartbeat/membership split: workers never talk
        # to the supervisor). A future callback/timer method must
        # declare its `# thread: <domain>` and leave `supervisor`-domain
        # state alone.
        self.handles: Dict[str, WorkerHandle] = {
            wid: WorkerHandle(wid) for wid in self.worker_ids
        }  # guarded-by: supervisor
        # audit trail for tests/operators
        self.events: List[dict] = []  # guarded-by: supervisor

    # --- internals ----------------------------------------------------
    def _event(self, kind: str, worker_id: str, **info):
        info.update({"kind": kind, "worker": worker_id,
                     "t": time.time()})
        self.events.append(info)

    def _spawn(self, h: WorkerHandle, membership=None):
        env = dict(os.environ if self.env_for is None
                   else (self.env_for(h.worker_id) or os.environ))
        if h.restarts and self.fault_once:
            env.pop(_FAULT_ENV, None)
        env["PADDLE_WORKER_ID"] = h.worker_id
        env["PADDLE_RESTART_COUNT"] = str(h.restarts)
        # why the predecessor died (crash/sentinel_rollback/hang), so
        # the worker can announce it in its register_worker meta and
        # operators can tell divergence churn from crash loops in the
        # coordinator membership
        env["PADDLE_RESTART_REASON"] = h.last_restart_reason or "none"
        # snapshot whatever membership record is ALREADY there (the dead
        # predecessor's, usually): only a record with a different
        # incarnation can vouch for — or condemn — the new process. A
        # BLIND spawn (no view at all) defers the snapshot to the first
        # visible sweep via the sentinel — an empty view is a real
        # "no record" snapshot, a None view is not.
        if membership is None:
            h.spawn_incarnation = _BLIND_SPAWN
        else:
            m = membership.get(h.worker_id)
            h.spawn_incarnation = m["incarnation"] if m else None
        h.proc = subprocess.Popen(self.argv_for(h.worker_id), env=env)
        h.spawned_at = time.time()
        self._event("spawn", h.worker_id, pid=h.proc.pid,
                    restart=h.restarts)

    def _membership(self):
        """Fresh membership view, or None when there is no view at all
        (no coordinator configured, or it is partitioned/bouncing) —
        None disables hang detection for this sweep so that a blind
        supervisor never SIGKILLs a healthy worker. An EMPTY dict is a
        real view (nobody registered yet) and keeps the spawn grace
        armed.

        A RemoteCoordinator's per-call retry deadline is clamped to
        `membership_deadline_s` for this one call: supervision must keep
        sweeping (reaping exits, respawning) during a partition, not sit
        in the client's full 30 s backoff loop once per sweep."""
        if self.coordinator is None:
            return None
        c = self.coordinator
        prev = getattr(c, "retry_deadline_s", None)
        if prev is not None:
            c.retry_deadline_s = min(prev, self.membership_deadline_s)
        try:
            return c.membership()
        except Exception:
            return None
        finally:
            if prev is not None:
                c.retry_deadline_s = prev

    def _handle_death(self, h: WorkerHandle, rc: int, hang: bool = False,
                      detect_lag: float = 0.0):
        """`detect_lag` is how long the failure necessarily sat
        undetected (heartbeat deadline for a hang, spawn grace for a
        startup wedge): it is subtracted from uptime before the rapid
        test, so a worker that wedges INSTANTLY every incarnation still
        counts as crash-looping even though each kill lands minutes
        after the spawn."""
        uptime = time.time() - h.spawned_at
        h.exit_codes.append(rc)
        if rc == 0 and not hang:
            h.done = True
            self._event("done", h.worker_id, uptime=round(uptime, 3))
            return
        sentinel = (not hang) and rc == self.sentinel_exit_code
        if sentinel:
            # an ORDERLY rollback request, not a failure of the process:
            # budgeted on its own counter so divergence churn can never
            # masquerade as (or hide inside) a crash loop
            h.sentinel_rollbacks += 1
            reason = "sentinel_rollback"
            self._event("sentinel_rollback", h.worker_id, rc=rc,
                        uptime=round(uptime, 3),
                        rollbacks=h.sentinel_rollbacks)
        else:
            reason = "hang" if hang else "crash"
            rapid = (uptime - detect_lag) < self.min_uptime_s
            h.rapid_failures = h.rapid_failures + 1 if rapid else 0
            self._event("hang_kill" if hang else "crash", h.worker_id,
                        rc=rc, uptime=round(uptime, 3), rapid=rapid)
        h.last_restart_reason = reason
        h.restart_reasons.append(reason)
        if self.ckpt_dir_for is not None:
            try:
                ckpt_dir = self.ckpt_dir_for(h.worker_id)
                _ckpt.retain(ckpt_dir, keep_last=self.ckpt_keep_last,
                             protect=_sentinel.known_good_step(ckpt_dir))
            except OSError:
                pass  # GC is best-effort; the restart matters more
        if sentinel:
            if h.sentinel_rollbacks >= self.sentinel_rollback_max:
                h.abandoned = True
                h.proc = None
                self._event("abandon", h.worker_id,
                            sentinel_rollbacks=h.sentinel_rollbacks)
                return
            backoff_exp = h.sentinel_rollbacks - 1
        else:
            if h.rapid_failures >= self.restart_max:
                h.abandoned = True
                h.proc = None
                self._event("abandon", h.worker_id,
                            rapid_failures=h.rapid_failures)
                return
            backoff_exp = h.rapid_failures - 1
        h.restarts += 1
        delay = restart_backoff_s(backoff_exp + 1,
                                  base=self.restart_backoff_s)
        h.next_spawn_at = time.time() + delay
        h.proc = None

    def _check_hang(self, h: WorkerHandle, membership):
        m = membership.get(h.worker_id)
        now = time.time()
        if h.spawn_incarnation is _BLIND_SPAWN:
            # first visible sweep after a blind spawn: take the baseline
            # snapshot _spawn could not. Whatever record is here now is
            # treated as predating this process (the dead predecessor's,
            # usually) — only a LATER registration can vouch for or
            # condemn it. Never kill on the sweep the view healed; if
            # the record is actually this process's own registration,
            # hang detection degrades to the spawn-grace path, which is
            # safe (conservative) rather than lethal.
            h.spawn_incarnation = m["incarnation"] if m else None
            return False
        if m is not None and m.get("incarnation") != h.spawn_incarnation:
            # the registry holds a record NEWER than whatever was there
            # when this process spawned, so THIS incarnation registered
            # itself — attribution by incarnation counter, never by
            # comparing the coordinator's clock against ours (clock skew
            # must not let a dead predecessor's record condemn a fresh
            # restart). Trust the coordinator's liveness deadline.
            h.member_seen = now
            if not m["alive"]:
                return True
        elif h.member_seen >= h.spawned_at:
            # this incarnation WAS in membership but vanished: the
            # coordinator restarted and lost its (ephemeral) registry.
            # The worker is not suspect — it re-registers on its next
            # heartbeat; killing it here would punish a healthy worker
            # for a coordinator bounce.
            return False
        elif now - h.spawned_at > self.spawn_grace_s:
            if m is not None and m["alive"]:
                # an actively-refreshed record under OUR worker id can
                # only be this process (the supervisor runs one process
                # per id and reaped the predecessor): an incarnation
                # collision after a coordinator bounce must not read as
                # "never registered". Don't kill — and don't attribute
                # either: if the refreshes stop, the expiry lands here.
                return False
            # never registered (or only the predecessor's stale record
            # remains): wedged during startup (import deadlock, bad
            # address). The grace is generous because interpreter + jit
            # warmup legitimately take many seconds.
            return True
        return False

    # --- lifecycle ----------------------------------------------------
    def start(self):
        """Spawn workers that are not already running. Idempotent, so
        start()+run() (run() calls start() itself) cannot double-spawn a
        worker and orphan the first process."""
        membership = self._membership()
        for wid in self.worker_ids:
            h = self.handles[wid]
            if not (h.running or h.done or h.abandoned):
                self._spawn(h, membership)
        return self

    def poll(self) -> bool:
        """One supervision sweep. Returns True when every worker is
        either done or abandoned (the job cannot change state again)."""
        membership = self._membership()
        for h in self.handles.values():
            if h.done or h.abandoned:
                continue
            if h.proc is None:
                if time.time() >= h.next_spawn_at:
                    self._spawn(h, membership)
                continue
            rc = h.proc.poll()
            if rc is not None:
                self._handle_death(h, rc)
                continue
            if membership is not None and self._check_hang(h, membership):
                # the failure predates its detection by the heartbeat
                # deadline (registered worker gone silent) or the spawn
                # grace (never-registered wedge) — tell _handle_death so
                # deterministic hang/wedge loops still read as rapid
                lag = (self.heartbeat_timeout_s
                       if h.member_seen >= h.spawned_at
                       else self.spawn_grace_s)
                h.hang_kills += 1
                h.proc.send_signal(signal.SIGKILL)
                h.proc.wait()
                self._handle_death(h, -signal.SIGKILL, hang=True,
                                   detect_lag=lag)
        return all(h.done or h.abandoned for h in self.handles.values())

    def run(self, deadline_s: float = 600.0) -> dict:
        """Supervise until the job drains (all workers done/abandoned) or
        the deadline passes; always reaps children. Returns the report:

            {"ok": bool,            # all done, nobody abandoned
             "timed_out": bool,
             "workers": {wid: {restarts, hang_kills, abandoned, ...}},
             "events": [...]}
        """
        deadline = time.monotonic() + deadline_s
        self.start()
        try:
            timed_out = False
            while not self.poll():
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(self.poll_s)
        finally:
            self.stop()
        return {
            "ok": (not timed_out
                   and all(h.done for h in self.handles.values())),
            "timed_out": timed_out,
            "workers": {
                wid: h.summary() for wid, h in self.handles.items()
            },
            "events": list(self.events),
        }

    def stop(self):
        """Kill every still-running worker (shutdown / deadline path)."""
        for h in self.handles.values():
            if h.proc is not None and h.proc.poll() is None:
                h.proc.send_signal(signal.SIGKILL)
                h.proc.wait()
