"""Fault injection as a first-class fixture (SURVEY §5.3: the reference
had no injection framework — its elasticity was only provable on a live
cluster; here preemptions/crashes/stalls are injectable into any worker
or the trainer CLI itself, so recovery paths are CI-testable).

A fault spec is a comma-separated string, e.g.::

    PADDLE_FAULT="kill@12"          SIGKILL self at step 12 (preemption)
    PADDLE_FAULT="exc@7"            raise FaultInjected at step 7
    PADDLE_FAULT="delay@3:0.5"      sleep 0.5s at step 3 (straggler)
    PADDLE_FAULT="corrupt@5:/path"  flip bytes of a file at step 5
    PADDLE_FAULT="hang@4"           spin forever at step 4 (livelock: the
                                    process stays up but makes no
                                    progress — only a heartbeat timeout
                                    can detect it)
    PADDLE_FAULT="netsplit@3:2.0"   drop coordinator connections for 2 s
                                    starting at step 3 (partition: RPCs
                                    fail and must ride it out on backoff)
    PADDLE_FAULT="nanloss@5"        SILENT failure the loss
                                    the training loop observes at step 5
                                    becomes NaN — the process neither
                                    crashes nor hangs; only the training
                                    sentinel's divergence detection can
                                    see it. The loop opts in by passing
                                    its loss through
                                    `injector.poison_loss(loss)`.
    PADDLE_FAULT="spike@5:50"       soft SILENT failure: the observed
                                    loss at step 5 is multiplied by 50 —
                                    a one-step spike the sentinel's
                                    EWMA + hysteresis must classify
                                    (transient: tolerated; sustained:
                                    tripped). Arg is the factor,
                                    default 10, must be > 1.
    PADDLE_FAULT="garble@5"         SILENT serving integrity fault
                                    from step 5 ON, every
                                    token this engine emits is
                                    wrong-but-FINITE (the engine
                                    consumes `injector.garbled` and
                                    perturbs each emitted token to a
                                    different valid vocab id). STICKY
                                    by design — a faulty core keeps
                                    computing wrong until the
                                    incarnation is replaced — so the
                                    in-step numeric traps never fire
                                    (nothing is NaN) and only a
                                    known-answer canary mismatch can
                                    catch it. Models the SDC failure
                                    class large fleets see.
    PADDLE_FAULT="flip@5"           SILENT serving integrity fault
                                    at step 5 the engine
                                    corrupts ONE resident KV block's
                                    payload in place (finite garbage,
                                    lowest in-use physical id —
                                    deterministic on a fixed-seed
                                    trace; consumed via
                                    `injector.take_flip()`, re-armed
                                    each tick until a block is
                                    resident). Requests attending
                                    through the block decode wrong
                                    tokens; only a block FINGERPRINT
                                    spot-check (at aliased re-open /
                                    failover resume) can catch it.
    PADDLE_FAULT="store_corrupt@2"  SILENT durable-KV fault:
                                    the 2nd record put into the
                                    KVBlockStore is garbled AT REST
                                    (one payload byte flipped in RAM
                                    and in store.jsonl; the recorded
                                    crc stays honest, so only the read
                                    path's crc check can catch it).
                                    N counts STORE RECORDS, not steps
                                    — the store consumes these via
                                    `injector.store_tick()` per put.
                                    Import/warm paths must skip +
                                    quarantine the record and fall
                                    back to re-prefill, counted,
                                    token-identical.
    PADDLE_FAULT="store_trunc@2"    as store_corrupt@N but the record's
                                    payload is TRUNCATED (the torn-
                                    write shape: nbytes disagrees with
                                    the bytes present).
    PADDLE_FAULT="slow@3:2.0/0.1"   GRAY failure starting at
                                    step 3, every tick sleeps 0.1 s until
                                    2.0 s of wall time have passed — the
                                    process keeps heartbeating (each step
                                    completes!) but is too slow to meet
                                    latency targets. Unlike delay@ (one
                                    pause) or hang@ (no progress at all),
                                    slow@ is invisible to liveness checks
                                    and only detectable by step-latency /
                                    progress-watermark health scoring
                                    (the fleet's slow_replica_factor
                                    demotion). Arg is dur[/per]; per
                                    defaults to 0.05 s.

The trainer CLI ticks its injector once per batch when PADDLE_FAULT is
set; worker scripts call `default_injector().tick()` wherever their
step boundary is.

Serving semantics `ServingEngine.step()` is a step boundary
too — when PADDLE_FAULT is set, every scheduler step (one admission +
prefill-chunk + batched-decode round) ticks the default injector, so
`kill@N` SIGKILLs a serving replica mid-decode, `delay@N:dur` turns it
into a straggler that misses its fleet heartbeat deadline (zombie
drill), and `exc@N` crashes the replica thread in-process. Fleet kill
drills count on this: N is a deterministic engine-step index on a
fixed-seed trace, so the fault lands with requests in flight and the
journal-resubmit/failover path is exercised, not the happy path. An
engine can also be handed its OWN `FaultInjector` (the in-process fleet
drills do, one per replica) — the env-driven default stays process-wide
on purpose, like a host-level fault.
"""

from __future__ import annotations

import os
import signal
import time
from typing import List, Optional

__all__ = [
    "FaultInjected", "FaultInjector", "default_injector", "corrupt_file",
    "netsplit_active",
]

ENV_VAR = "PADDLE_FAULT"

# wall-clock end of the current injected partition window (0 = none).
# Process-wide on purpose: every RemoteCoordinator in the process loses
# its "network" at once, like a real NIC/switch failure would look from
# one host.
_netsplit_until = 0.0


def netsplit_active() -> bool:
    """True while an injected netsplit window is open. Transport clients
    (RemoteCoordinator) consult this and drop/refuse connections so the
    partition is exercised end-to-end without real firewalling."""
    return time.time() < _netsplit_until


class FaultInjected(RuntimeError):
    """Raised by exc@N faults."""


def corrupt_file(path: str, offset: int = -4, flip: bytes = b"\x5a"):
    """Flip byte(s) in `path` (checkpoint-corruption fixture: the CRC
    check must reject the file afterwards)."""
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END if offset < 0 else os.SEEK_SET)
        pos = f.tell()
        raw = f.read(len(flip))
        if len(raw) != len(flip):
            raise ValueError(
                "corrupt_file: offset %d leaves only %d byte(s) to flip "
                "in %s" % (offset, len(raw), path)
            )
        f.seek(pos)
        f.write(bytes(b ^ f2 for b, f2 in zip(raw, flip)))


class _Fault(object):
    def __init__(self, kind: str, step: int, arg: Optional[str]):
        self.kind = kind
        self.step = step
        self.arg = arg

    def fire(self):
        if self.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif self.kind == "exc":
            raise FaultInjected("injected fault at step %d" % self.step)
        elif self.kind == "delay":
            time.sleep(float(self.arg or "1.0"))
        elif self.kind == "corrupt":
            corrupt_file(self.arg)
        elif self.kind == "hang":
            # livelock, NOT a crash: the process keeps its sockets and
            # pid, stops heartbeating, and never returns — detectable
            # only by the supervisor's heartbeat deadline. sleep in
            # small slices so an external SIGKILL reaps promptly.
            while True:
                time.sleep(0.05)
        elif self.kind == "netsplit":
            global _netsplit_until
            _netsplit_until = time.time() + float(self.arg or "1.0")
        else:
            raise ValueError("unknown fault kind %r" % self.kind)


_KINDS = ("kill", "exc", "delay", "corrupt", "hang", "netsplit", "slow",
          "nanloss", "spike", "garble", "flip", "store_corrupt",
          "store_trunc")

# fault kinds whose @N indexes the Nth KV-STORE record, not the Nth
# step boundary: tick() never fires them, store_tick() consumes them,
# and arm(relative=True) must NOT shift their index by the step count
_STORE_KINDS = ("store_corrupt", "store_trunc")


def _parse_slow_arg(arg: str):
    """slow@N:dur[/per] -> (window_s, per_tick_sleep_s), validated —
    a bad window or a negative stall must fail at PARSE time, not as
    a time.sleep(-x) crash loop N serving steps later."""
    dur_s, _, per_s = (arg or "1.0").partition("/")
    dur, per = float(dur_s), float(per_s or "0.05")
    if dur <= 0.0:
        raise ValueError("slow@N:dur needs a positive window, got %r" % dur)
    if per < 0.0:
        raise ValueError("slow@N:dur/per needs per >= 0, got %r" % per)
    return dur, per


def _parse(spec: str) -> List[_Fault]:
    faults = []
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        kind, _, rest = part.partition("@")
        kind = kind.strip()
        step_s, _, arg = rest.partition(":")
        # a bad spec must fail HERE, not N training steps later
        if kind not in _KINDS:
            raise ValueError(
                "unknown fault kind %r (want one of %s)" % (kind, _KINDS)
            )
        if kind == "corrupt" and not arg:
            raise ValueError("corrupt@N:<path> needs the file path")
        if kind in ("delay", "netsplit"):
            arg = str(float(arg or "1.0"))  # fail fast on a bad duration
        if kind == "slow":
            _parse_slow_arg(arg)  # fail fast on a bad dur[/per]
        if kind == "spike":
            mag = float(arg or "10")
            if mag <= 1.0:
                raise ValueError(
                    "spike@N:mag needs a factor > 1, got %r" % mag)
            arg = str(mag)
        faults.append(_Fault(kind, int(step_s), arg or None))
    return faults


class FaultInjector(object):
    """Counts step boundaries via tick(); fires matching faults."""

    def __init__(self, spec: Optional[str] = None):
        self.faults = _parse(
            spec if spec is not None else os.environ.get(ENV_VAR, "")
        )
        self.step = 0
        # open slow@ window: (wall end, per-tick sleep). Injector state,
        # not _Fault state: the window outlives the step that opened it
        self._slow_until = 0.0
        self._slow_per = 0.0
        # armed loss fault for the CURRENT step, consumed (one-shot) by
        # poison_loss(): ("nanloss", None) or ("spike", factor)
        self._loss_fault = None
        # serving integrity faults garble is STICKY from
        # its step on (a faulty core keeps computing wrong); flip is
        # armed at its step and stays pending until the engine finds a
        # resident block to corrupt (take_flip consumes it)
        self._garbled = False
        self._flip_pending = False
        # durable-KV faults store_corrupt@N/store_trunc@N
        # count STORE RECORDS — the KVBlockStore ticks this counter
        # once per put and the matching fault fires one-shot
        self._store_puts = 0

    @property
    def active(self) -> bool:
        return bool(self.faults)

    @property
    def slowed(self) -> bool:
        """True while an injected slow@ (gray) window is open."""
        return time.monotonic() < self._slow_until

    @property
    def garbled(self) -> bool:
        """True from a garble@ step on (sticky): the consuming engine
        perturbs every emitted token to a wrong-but-finite vocab id."""
        return self._garbled

    def rearm_flip(self):
        """Put a consumed flip@ back (the engine found nothing resident
        to corrupt this step — retry at the next step boundary)."""
        self._flip_pending = True

    def take_flip(self) -> bool:
        """Consume a pending flip@ fault. The engine calls this every
        step; the first call with a resident KV block to corrupt wins
        (the fault stays pending across ticks where nothing is
        resident, so flip@1 on an idle engine still lands on the first
        real block)."""
        if self._flip_pending:
            self._flip_pending = False
            return True
        return False

    def arm(self, spec: str, relative: bool = True):
        """Add faults mid-run. With `relative=True` (default) the @N
        indices count from the CURRENT step — `arm("delay@3:1.0")`
        fires three ticks from now. Drills use this to warm a system up
        (compile, prime caches) under no faults and then schedule the
        fault at a deterministic step of the measured phase, without
        hand-counting the warm-up's ticks. Store faults shift by the
        STORE-RECORD counter instead — their @N never counted steps."""
        new = _parse(spec)
        if relative:
            for f in new:
                f.step += (self._store_puts if f.kind in _STORE_KINDS
                           else self.step)
        self.faults.extend(new)

    def store_tick(self):
        """Advance the KV-store record counter (the KVBlockStore calls
        this once per `put`); returns "corrupt" / "trunc" when the Nth
        record has a store fault armed (one-shot), else None."""
        self._store_puts += 1
        for f in self.faults:
            if (f.kind in _STORE_KINDS and f.step == self._store_puts
                    and not getattr(f, "spent", False)):
                f.spent = True  # one-shot: the Nth record, exactly once
                return f.kind[len("store_"):]
        return None

    def tick(self):
        """Advance one step; fire any fault scheduled for it. While a
        slow@ window is open every tick sleeps the window's per-step
        stall — the step COMPLETES (heartbeats keep flowing), it is
        just late: the gray-failure shape delay@/hang@ cannot model."""
        self.step += 1
        for f in self.faults:
            if f.step == self.step:
                if f.kind == "slow":
                    dur, per = _parse_slow_arg(f.arg)
                    self._slow_until = time.monotonic() + dur
                    self._slow_per = per
                elif f.kind in ("nanloss", "spike"):
                    # silent fault: nothing fires HERE — the training
                    # loop's poison_loss() call this step observes it
                    self._loss_fault = (f.kind, f.arg)
                elif f.kind == "garble":
                    # silent + sticky: the serving engine consumes the
                    # `garbled` property on every emission from now on
                    self._garbled = True
                elif f.kind == "flip":
                    # silent one-shot: pending until take_flip() finds
                    # a resident block to corrupt
                    self._flip_pending = True
                elif f.kind in _STORE_KINDS:
                    # counted in STORE RECORDS, not steps: only
                    # store_tick() may consume these (a step index
                    # colliding with @N must not fire them)
                    pass
                else:
                    f.fire()
        if self.slowed:
            time.sleep(self._slow_per)
        return self.step

    def poison_loss(self, loss):
        """Pass the step's observed loss through any armed silent loss
        fault (nanloss@/spike@) and disarm it. Training loops that
        integrate the sentinel call this right after computing their
        loss; loops that don't are simply immune to these fault kinds
        (the spec parses, nothing fires)."""
        lf = self._loss_fault
        self._loss_fault = None
        if lf is None:
            return loss
        kind, arg = lf
        if kind == "nanloss":
            return float("nan")
        return float(loss) * float(arg or "10")


_default: Optional[FaultInjector] = None


def default_injector() -> FaultInjector:
    """Process-wide injector built from PADDLE_FAULT (parsed once)."""
    global _default
    if _default is None:
        _default = FaultInjector()
    return _default
