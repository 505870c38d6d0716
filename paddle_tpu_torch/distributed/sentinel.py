"""Training health sentinel: silent-failure tolerance for training
(counterpart of paddle_tpu/distributed/sentinel.py; `sentinel.json` and
the quarantine journal are the JAX package's JSON, so either package
resumes under the other's state).

The elastic stack (supervisor + checkpoint + loader) tolerates fail-stop
faults: a crashed or hung trainer restarts from its latest checkpoint at
the exact step. But three failures are SILENT — the process keeps
running (or keeps restarting into the same doom) while the run is
already ruined:

  divergence      the loss goes NaN/Inf, or spikes away from its recent
                  trajectory, and every later step trains on garbage —
                  the reference's FLAGS.check_nan_inf stops at "raise
                  and die" (executor.cc:132-140); a restart from the
                  LATEST checkpoint restores the already-poisoned state
  poisoned data   a corrupt/adversarial chunk re-poisons the run on
                  every pass over it: restart alone loops forever
  torn checkpoint a corrupted latest step dir makes even fail-stop
                  recovery raise instead of resuming

This module closes all three with one control loop:

  1. DETECTION (`DivergenceDetector`): a hard trip on any non-finite
     loss/grad-norm (the runtime numerics guard's verdict, upgraded
     from raise-and-die to detect-and-recover) plus a soft trip when
     the loss exceeds `spike_factor` x its EWMA for `hysteresis`
     consecutive steps (one noisy step decays out). Suspect losses are NOT folded into the EWMA, so a
     slow-motion blowup cannot drag its own baseline up.
  2. KNOWN-GOOD PROMOTION + ROLLBACK (`TrainingSentinel`): a checkpoint
     becomes *known-good* only after the run survives `promote_after`
     further healthy steps. On a trip, step dirs newer than known-good
     are set aside as `<dir>.diverged` (kept for forensics, invisible
     to resume) and the worker restarts from the known-good step with
     exact step/loader-cursor continuity — not from the latest, whose
     state already absorbed the divergence.
  3. POISONED-DATA QUARANTINE: each trip attributes its divergence
     window to the chunks consumed since the known-good cursor (the
     loader's deterministic (epoch, pos, offset) stream makes the set
     exact). After `rollback_budget` trips inside the same window the
     suspect chunk ids are journaled to the quarantine file, which
     `ShardedDataset`/the chunk sources skip deterministically on every
     later pass; the run abandons only if divergence persists with the
     chunks excluded.

Cross-incarnation memory (trip counts, known-good step, candidates)
lives in `<ckpt_dir>/sentinel.json`, committed atomically — it must
SURVIVE the rollback that restores everything else to the past. The
detector's EWMA state instead rides inside the checkpoint
(`stateful={"detector": sentinel.detector}`) so a rollback also
restores the pre-divergence loss baseline.

The sentinel itself is single-threaded trainer-loop state BY DESIGN
(like the Supervisor): it is called once per step from the training
loop and never from callbacks or timers, so its fields are domain-
annotated rather than locked.
"""

from __future__ import annotations

import json
import logging
import os
from typing import FrozenSet, List, Optional

import torch

from ..utils.detector import TripDetector

__all__ = [
    "DivergenceDetector", "TrainingSentinel", "SentinelTrip",
    "quarantine_chunks", "quarantine_entries", "quarantined_chunks",
    "chunks_consumed", "known_good_step",
]

_LOG = logging.getLogger(__name__)

STATE_FILE = "sentinel.json"

#: exit code a supervised worker uses to signal "orderly sentinel
#: rollback, respawn me" (EX_TEMPFAIL) — the Supervisor budgets these
#: separately from crash loops.
SENTINEL_EXIT_CODE = 75


class SentinelTrip(RuntimeError):
    """Raised by `TrainingSentinel.observe(raise_on_trip=True)`; carries
    the trip decision in `.decision`."""

    def __init__(self, decision: dict):
        super(SentinelTrip, self).__init__(
            "sentinel trip at step %d (%s): %s -> step %s" % (
                decision["step"], decision["verdict"],
                decision["action"], decision["rollback_to"]))
        self.decision = decision


class DivergenceDetector(TripDetector):
    """Per-step loss/grad-norm health verdicts.

    observe(loss, grad_norm) -> "ok" | "nonfinite" | "spike"

      nonfinite  any non-finite loss or grad norm: trips IMMEDIATELY
                 (a NaN is already in the parameters' future)
      spike      loss > spike_factor * EWMA(loss) for `hysteresis`
                 consecutive steps (after `warmup` healthy
                 observations seed the EWMA)

    Suspect steps never update the EWMA; a sub-hysteresis excursion
    resets the streak and decays normally. State is JSON-serializable
    (`state_dict`/`load_state_dict`) so it can ride in the checkpoint
    and roll BACK with the model on a sentinel rollback.

    The verdict machine itself is `utils.detector.TripDetector`: ONE
    hysteresis implementation shared with the serving integrity
    sentinel, so the two health loops cannot drift. This subclass only
    keeps the training-side signature (loss + grad_norm), each a Python
    float or a tensor, read once (`_scalar`).
    """

    def observe(self, loss, grad_norm=None) -> str:
        return TripDetector.observe(self, _scalar(loss),
                                    aux_finite=_scalar(grad_norm))


def _scalar(v):
    """A one-element tensor as a Python float, read from the device
    once (the loss the training loop already reads back); anything
    else as it is."""
    if isinstance(v, torch.Tensor):
        return v.item()
    return v


# ---------------------------------------------------------------------
# quarantine journal: the durable, deterministic chunk blocklist
# ---------------------------------------------------------------------


def quarantine_entries(path: Optional[str]) -> List[dict]:
    """All journal entries (one JSON object per line), oldest first.
    Malformed lines are skipped — the journal must degrade, never wedge
    a resume."""
    if not path or not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                ent = json.loads(line)
            except ValueError:
                continue
            if isinstance(ent, dict) and "chunk" in ent:
                out.append(ent)
    return out


def quarantined_chunks(path: Optional[str]) -> FrozenSet[int]:
    return frozenset(int(e["chunk"]) for e in quarantine_entries(path))


def quarantine_chunks(path: str, chunk_ids, **info) -> List[int]:
    """Journal `chunk_ids` to the quarantine file (idempotent: ids
    already journaled are skipped, so a chunk appears EXACTLY once no
    matter how many rollback rounds re-accuse it). The whole file is
    rewritten through an atomic rename — a crash mid-quarantine leaves
    the previous journal intact. Returns the newly journaled ids,
    sorted (deterministic across reruns of a deterministic job)."""
    have = quarantined_chunks(path)
    fresh = sorted(int(c) for c in set(chunk_ids) if int(c) not in have)
    if not fresh:
        return []
    lines = [json.dumps(e, sort_keys=True) for e in quarantine_entries(path)]
    for c in fresh:
        ent = {"chunk": c}
        ent.update(info)
        lines.append(json.dumps(ent, sort_keys=True))
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return fresh


def chunks_consumed(dataset, cur_from: Optional[dict],
                    cur_to: Optional[dict]) -> List[int]:
    """Chunk ids whose records were delivered between two loader
    cursors — the divergence-attribution window. Exact because the
    delivered stream is a pure function of (seed, epoch): chunks visit
    in `dataset.epoch_order(epoch)` order and a cursor (epoch, pos,
    offset) names the next undelivered record.

    The chunk at `cur_from` is included only while records remain in it
    (a cursor parked exactly on a chunk's end — offset == its record
    count, the shape a batch that completes a chunk leaves behind —
    consumed that chunk BEFORE the window); the chunk at `cur_to` is
    included only once records were actually taken from it
    (offset > 0). Quarantined chunks are excluded — they were never
    delivered."""
    if cur_from is None:
        cur_from = {"epoch": 0, "pos": 0, "offset": 0}
    if cur_to is None:
        return []
    e0, p0, o0 = int(cur_from["epoch"]), int(cur_from["pos"]), int(
        cur_from["offset"])
    e1, p1, o1 = int(cur_to["epoch"]), int(cur_to["pos"]), int(
        cur_to["offset"])
    out = set()
    for epoch in range(e0, e1 + 1):
        order = dataset.epoch_order(epoch)
        if epoch == e0:
            lo = p0
            if (p0 < len(order)
                    and o0 >= dataset.chunks[int(order[p0])].records):
                lo = p0 + 1  # left-edge chunk fully consumed pre-window
        else:
            lo = 0
        if epoch == e1:
            hi = p1 + 1 if o1 > 0 else p1
        else:
            hi = len(order)
        for i in range(lo, min(hi, len(order))):
            ci = int(order[i])
            if not dataset.is_quarantined(ci):
                out.add(ci)
    return sorted(out)


def known_good_step(ckpt_dir: str) -> Optional[int]:
    """The last promoted known-good step recorded in `ckpt_dir`'s
    sentinel state, or None (no sentinel ran / nothing promoted yet).
    The Supervisor's checkpoint GC consults this so `retain()` can
    never collect the one step a rollback needs."""
    state = _load_state(os.path.join(ckpt_dir, STATE_FILE))
    kg = state.get("known_good")
    return int(kg["step"]) if kg else None


def _load_state(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


class TrainingSentinel(object):
    """The training loop's health sentinel: detection + known-good
    promotion + rollback/quarantine decisions.

    Per-step protocol (the drill worker of phase 41 of chip_smoke.py
    follows it)::

        decision = sentinel.observe(step, loss, cursor=loader.state_dict())
        if decision is not None:
            sys.exit(sentinel.SENTINEL_EXIT_CODE)   # supervisor respawns
        ...apply update, maybe checkpoint...
        if checkpointed:
            sentinel.on_checkpoint(step, cursor=loader.state_dict())

    On resume call `align(step)` with the restored step so candidates
    newer than the restored state are forgotten.

    Arguments:
      ckpt_dir         checkpoint root; `sentinel.json` lives here and
                       trip handling renames this root's diverged steps
      quarantine_path  chunk quarantine journal (None disables data
                       attribution/quarantine: trips only roll back)
      dataset          the ShardedDataset (epoch_order/is_quarantined)
                       used for window attribution; optional
      promote_after    healthy steps a checkpoint must survive before
                       it is promoted to known-good (K)
      rollback_budget  trips inside one divergence window before the
                       window's suspect chunks are quarantined (R)
      quarantine_rounds_max  quarantine rounds before the sentinel
                       abandons (divergence persists with chunks
                       excluded)
      detector         a DivergenceDetector (default-constructed when
                       omitted); checkpoint it via
                       `stateful={"detector": sentinel.detector}` so
                       the loss baseline rolls back with the model
    """

    def __init__(self, ckpt_dir: str, quarantine_path: Optional[str] = None,
                 dataset=None, promote_after: int = 10,
                 rollback_budget: int = 2,
                 quarantine_rounds_max: int = 3,
                 detector: Optional[DivergenceDetector] = None):
        if promote_after < 1:
            raise ValueError("promote_after must be >= 1")
        if rollback_budget < 1:
            raise ValueError("rollback_budget must be >= 1")
        self.ckpt_dir = ckpt_dir
        self.quarantine_path = quarantine_path
        self.dataset = dataset
        self.promote_after = int(promote_after)
        self.rollback_budget = int(rollback_budget)
        self.quarantine_rounds_max = int(quarantine_rounds_max)
        self.detector = detector if detector is not None \
            else DivergenceDetector()
        self._state_path = os.path.join(ckpt_dir, STATE_FILE)
        # cross-incarnation control state; mirrored to sentinel.json on
        # every mutation. Single-threaded trainer-loop state (see
        # module docstring) — domain-annotated, not locked.
        self._state = _load_state(self._state_path)  # guarded-by: trainer
        self._state.setdefault("version", 1)
        self._state.setdefault("known_good", None)
        self._state.setdefault("candidates", [])
        self._state.setdefault("rollbacks", None)
        self._state.setdefault("quarantine_rounds", 0)
        self._state.setdefault("trips", [])
        # cursor of the last genuinely healthy step THIS incarnation
        # (verdict ok, no open spike streak). Trip attribution starts
        # here when available — a hard NaN accuses only the chunks
        # entered since the last healthy step, not everything since
        # known-good; when no healthy step has been seen yet (fresh
        # resume) the known-good cursor is the conservative fallback.
        self._healthy_cursor = None  # guarded-by: trainer

    # --- introspection -------------------------------------------------
    @property
    def known_good_step(self) -> Optional[int]:
        kg = self._state["known_good"]
        return int(kg["step"]) if kg else None

    @property
    def known_good_cursor(self) -> Optional[dict]:
        kg = self._state["known_good"]
        return kg.get("cursor") if kg else None

    @property
    def trips(self) -> List[dict]:
        return list(self._state["trips"])

    def summary(self) -> dict:
        return {
            "known_good_step": self.known_good_step,
            "candidates": [c["step"] for c in self._state["candidates"]],
            "trips": len(self._state["trips"]),
            "quarantine_rounds": self._state["quarantine_rounds"],
        }

    # --- lifecycle -----------------------------------------------------
    def align(self, step: Optional[int]):
        """Call after resume with the restored step: candidates newer
        than the restored state no longer describe durable checkpoints
        on the resumed timeline."""
        if step is None:
            return
        cands = [c for c in self._state["candidates"]
                 if int(c["step"]) <= int(step)]
        if len(cands) != len(self._state["candidates"]):
            self._state["candidates"] = cands
            self._persist()

    def on_checkpoint(self, step: int, cursor: Optional[dict] = None):
        """Register a just-committed checkpoint as a promotion
        candidate. `cursor` is the loader state_dict at the commit —
        it becomes the attribution window's left edge once promoted."""
        self._state["candidates"].append(
            {"step": int(step), "cursor": dict(cursor) if cursor else None})
        self._persist()

    def observe(self, step: int, loss, grad_norm=None,
                cursor: Optional[dict] = None,
                raise_on_trip: bool = False) -> Optional[dict]:
        """Feed one step's health signals. Healthy steps promote ripe
        candidates and return None; a divergence returns the trip
        decision (after persisting it and setting diverged step dirs
        aside) — the caller's only job is to exit with
        SENTINEL_EXIT_CODE (or re-enter its incarnation loop)."""
        verdict = self.detector.observe(loss, grad_norm=grad_norm)
        if verdict == "ok":
            if cursor is not None and not self.detector.suspect:
                self._healthy_cursor = dict(cursor)
            self._promote(int(step))
            return None
        decision = self._trip(int(step), verdict, cursor)
        if raise_on_trip:
            raise SentinelTrip(decision)
        return decision

    # --- internals -----------------------------------------------------
    def _promote(self, step: int):
        ripe = [c for c in self._state["candidates"]
                if int(c["step"]) + self.promote_after <= step]
        if not ripe:
            return
        newest = max(ripe, key=lambda c: int(c["step"]))
        self._state["known_good"] = newest
        self._state["candidates"] = [
            c for c in self._state["candidates"]
            if int(c["step"]) > int(newest["step"])]
        # a freshly promoted checkpoint opens a FRESH divergence window:
        # trip counting restarts relative to the new left edge
        self._state["rollbacks"] = None
        self._persist()

    def _trip(self, step: int, verdict: str, cursor: Optional[dict]) -> dict:
        kg_step = self.known_good_step
        suspects: List[int] = []
        if self.dataset is not None and cursor is not None:
            left = self._healthy_cursor or self.known_good_cursor
            suspects = chunks_consumed(self.dataset, left, cursor)
        rb = self._state["rollbacks"]
        same_window = rb is not None and rb.get("window") == kg_step
        count = (rb["count"] + 1) if same_window else 1
        action = "rollback"
        quarantined: List[int] = []
        if count >= self.rollback_budget:
            if (self.quarantine_path and suspects
                    and self._state["quarantine_rounds"]
                    < self.quarantine_rounds_max):
                quarantined = quarantine_chunks(
                    self.quarantine_path, suspects, step=step,
                    window=[kg_step, step], verdict=verdict,
                    reason="divergence window tripped %d time(s)" % count)
                self._state["quarantine_rounds"] += 1
                if self.dataset is not None:
                    self.dataset.reload_quarantine()
                action = "quarantine"
                count = 0  # fresh budget with the chunks excluded
            else:
                # nothing left to blame: the divergence is not the data
                action = "abandon"
        self._state["rollbacks"] = {"window": kg_step, "count": count}
        decision = {
            "step": step,
            "verdict": verdict,
            "action": action,
            "rollback_to": kg_step,
            "suspects": suspects,
            "quarantined": quarantined,
        }
        self._state["trips"].append(decision)
        if action != "abandon":
            self._set_aside_diverged(kg_step)
        self._persist()
        _LOG.warning(
            "sentinel trip at step %d (%s): %s -> rollback to %s%s",
            step, verdict, action, kg_step,
            (", quarantined chunks %s" % quarantined) if quarantined else "")
        return decision

    def _set_aside_diverged(self, kg_step: Optional[int]):
        """Rename step dirs NEWER than known-good to `<dir>.diverged`:
        their state absorbed the divergence, so the next resume must not
        see them — but they are forensic evidence, never deleted."""
        from . import checkpoint as _ckpt

        for s, path in _ckpt._list_step_dirs(self.ckpt_dir):
            if kg_step is not None and s <= kg_step:
                continue
            target = path + ".diverged"
            n = 1
            while os.path.exists(target):
                target = path + ".diverged.%d" % n
                n += 1
            try:
                os.replace(path, target)
            except OSError:
                pass  # a racing rename already moved it

    def _persist(self):
        os.makedirs(self.ckpt_dir, exist_ok=True)
        tmp = self._state_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._state, f, sort_keys=True)
        os.replace(tmp, self._state_path)
