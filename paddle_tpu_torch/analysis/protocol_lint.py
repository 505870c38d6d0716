"""Journal state-machine verifier: a per-rid DFA over `RequestJournal`
files (counterpart of paddle_tpu/analysis/protocol_lint.py; engine 1 of
2, sched_explore.py is the other). Journals of the two packages are
interchangeable: either verifier reads either package's files with the
same findings.

The serving fleet's correctness story is its request journal: every
submit/assign/progress/terminal transition is appended before the fleet
acts on it, and failover/restart recover FROM the file. Protocol bugs
found by review (idempotent-reject double counting,
superseded-assignment acceptance, probe wedges) all leave a
FINGERPRINT in the journal. This module
machine-checks that fingerprint: it replays a journal file through the
protocol DFA the fleet promises

    submit -> assign -> progress* ->
        exactly one of done|rejected|expired|cancelled

(`cancelled` is the client's terminal: a dropped wire
connection or cancel frame — closed like any verdict, and held to the
same accumulated-progress bar) and reports violations as stable
J-codes:

  J001 orphan-record      assign/progress/terminal for a rid this file
                          never saw submitted
  J002 duplicate-terminal a second terminal record for one rid
  J003 record-after-terminal  assign/progress after the rid's verdict
  J004 stale-fence        progress/done carrying a (replica,
                          incarnation, generation) that is not the
                          rid's LATEST assignment — the zombie-holder
                          acceptance the fleet's lease fence must refuse
  J005 progress-terminal-mismatch  a done/expired/cancelled record
                          whose tokens differ from the rid's
                          accumulated journaled progress (a re-decoded
                          or double-prepended token: the
                          superseded-report bug class)
  J006 unassigned-progress  progress from a named replica with no
                          assignment in effect (the restart-resume
                          record `__restart__` and compaction's
                          consolidated `replica: null` form are the two
                          sanctioned exceptions)
  J007 open-at-close      with `expect_closed=True`: a rid left open —
                          `ServingFleet.close()` promises every
                          journaled rid ends in a verdict
  J008 malformed-journal  unreadable mid-file record, unknown kind,
                          missing fields, or a compaction meta record
                          anywhere but the file head (compaction
                          REWRITES the file; meta mid-file means two
                          histories were glued together)
  J009 version-fence      a done record whose `weights_version` differs
                          from its latest assignment's (live
                          weight rollout): a mixed-version output is a
                          PROTOCOL violation, not just a test failure —
                          the fleet promises every response's verdict
                          version matches the assignment that produced
                          it. Checked only when both sides carry the
                          optional side-band; journals from an
                          unversioned fleet stay clean.
  J010 taint-fence        the integrity contract. An
                          `integrity` record quarantines a (replica,
                          incarnation) and TAINTS per-rid progress
                          windows [from, upto): the rid's accumulated
                          progress truncates to `from`, and ONLY the
                          tainted indices may ever be journaled twice
                          (the one sanctioned exception to the
                          zero-re-decode rule). J010 fires when (a)
                          progress re-covers an already-journaled
                          token index OUTSIDE any taint window — a
                          re-decode the protocol never sanctioned; (b)
                          an assign/progress/done names a quarantined
                          (replica, incarnation) AFTER its integrity
                          event — "a done whose assignment predates
                          the replica's integrity event"; (c) an
                          integrity record's taint window is
                          ill-formed (from > upto, from past the
                          journaled progress, an unknown or already-
                          terminal rid).
  J011 handoff-fence      the durable-KV contract. An assign
                          may carry a `handoff` side-band (`len` +
                          fingerprint `digest`: the checksummed block
                          package shipped at re-route) and a done the
                          matching outcome (`imported` tokens +
                          `fallback` flag). J011 fires when (a) a
                          FIRST assign (no prior assign, no journaled
                          history — compaction's consolidated progress
                          counts as history) carries handoff: packages
                          only attach at re-route, an admission-time
                          one is fabricated; (b) the package claims more
                          tokens than the prompt plus journaled
                          progress at assign time could have closed;
                          (c) a done carries an outcome but its latest
                          assignment shipped no package; (d) a done
                          whose holder received a package and actually
                          ran (tokens beyond the progress at assign)
                          reports NO outcome — every shipped package
                          must trace to a verified import or a counted
                          fallback, never silence; (e) an outcome
                          claims more imported tokens than its
                          assignment's package carried.

Optional side-band fields: assign records
may carry `tier` (prefill/decode disaggregation placement),
`weights_version` (the assignee's weight version), `tenant` (the
consumer whose quota admitted the request — the multi-tenant
exactly-once audit groups the journal by it), and `handoff` (the
block-package side-band); done records may carry
`weights_version`, `tenant`, and `handoff`. The front door
adds `conn` (the wire connection id that submitted the request) on
submit/progress/cancelled records and `stream` on submit (bool: the
client asked for token streaming) and progress (int: the journal's
cumulative generated-token count AFTER the record's tokens — the
stream cursor; it must equal the accumulated progress length, else
J008, because the streamed prefix is derived from it and a drifted
cursor means streamed tokens and the journal disagree).
Present-but-ill-typed side-band fields are J008 like any other field,
including the inner shape of `handoff` ({"len": int, "digest": str}
on assign, {"imported": int, "fallback": bool} on done).

A torn FINAL line is tolerated exactly like `RequestJournal._read`
(the crash the journal exists to survive must not fail its own audit);
torn-then-more-records is real corruption and reports J008.

Compaction invariant: a compacted file replays to the same open set and
the same concatenated progress prefixes — checked by running the same
DFA over the rewritten file (`verify_journal` after `compact()`); a
compaction that drops an open rid shows up as J001 (its later records
orphaned) or as a J005 prefix mismatch at its terminal.

Entry points: `verify_journal(path, expect_closed=False)` and
`verify_records(records)` (library; the port keeps no analysis CLI),
and the opt-in `PADDLE_TPU_AUDIT_JOURNAL=1` hook in
`ServingFleet.close()` which audits the live journal so every fleet
run double-checks itself for free.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from .diagnostics import Diagnostic, make, rel_path

__all__ = ["verify_journal", "verify_records", "JournalViolation"]

_TERMINAL = ("done", "rejected", "expired", "cancelled")
_KINDS = ("meta", "submit", "assign", "progress", "integrity") + _TERMINAL

# the front-door-restart resume prefix: journaled by submit() before any
# assignment exists, under this sentinel holder (fleet.py submit())
_RESTART = "__restart__"

_REQUIRED = {
    "meta": ("max_rid",),
    "submit": ("rid", "spec"),
    "assign": ("rid", "replica", "incarnation", "gen"),
    "progress": ("rid", "replica", "incarnation", "gen", "tokens"),
    "done": ("rid", "replica", "incarnation", "gen", "tokens"),
    "rejected": ("rid", "reason"),
    "expired": ("rid", "tokens"),
    # client-cancel terminal: the submitter walked away (a
    # dropped wire connection or cancel frame); `tokens` is the
    # journaled prefix emitted before the cancel — the DFA accepts it
    # as CLOSED (J007) and holds it to the same accumulated-progress
    # bar as done/expired (J005)
    "cancelled": ("rid", "tokens"),
    # quarantine record: no rid of its own — `taint` maps
    # rid -> [from, upto) windows over that rid's journaled progress
    "integrity": ("replica", "incarnation", "taint"),
}

# field -> accepted types: a JSON-parseable record with an ill-typed
# field is J008, never a TypeError out of the DFA (the never-crash
# contract). replica/incarnation/gen are nullable — compaction's
# consolidated progress form writes all three as null.
_FIELD_TYPES = {
    "rid": (int,),
    "max_rid": (int,),
    "spec": (dict,),
    "reason": (str,),
    "tokens": (list,),
    "replica": (str, type(None)),
    "incarnation": (int, type(None)),
    "gen": (int, type(None)),
    # side-band (optional on assign/done): nullable, because
    # an untiered/unversioned fleet writes them as null
    "tier": (str, type(None)),
    "weights_version": (int, type(None)),
    # side-band: the tenant whose quota admitted the request
    # (null on a single-tenant fleet) — a per-tenant exactly-once
    # audit groups the journal by this field, so an ill-typed value
    # silently breaks the grouping and must be J008 like any other
    "tenant": (str, type(None)),
    # the integrity record's rid -> [from, upto] window map
    "taint": (dict,),
    # the durable-KV handoff side-band — a package
    # description on assign, an import outcome on done (nullable: the
    # fleet writes null when no package rode the assignment)
    "handoff": (dict, type(None)),
    # wire side-band: the front-door connection id that owns
    # the request (submit/progress/cancelled). A restarted front door
    # groups orphaned streams by this field, so an ill-typed value is
    # J008 like tenant.
    "conn": (str, type(None)),
    # `stream` is a BOOL on submit (incremental delivery
    # requested) and an INT CURSOR on progress (accumulated journaled
    # length after the delta — what a restarted front door may have
    # already delivered). bool is accepted where int is only because
    # the per-kind check below pins the exact shape: a bool cursor on
    # progress is J008 despite Python's bool-is-int subtyping.
    "stream": (bool, int, type(None)),
}

# optional per-kind side-band fields: absent is fine (old journals),
# present-but-ill-typed is J008 like any required field
_OPTIONAL = {
    "submit": ("conn", "stream"),
    "assign": ("tier", "weights_version", "tenant", "handoff"),
    "progress": ("conn", "stream"),
    "done": ("weights_version", "tenant", "handoff"),
    "cancelled": ("conn",),
    "integrity": ("reason",),
}


def _bad_stream(rec, kind):
    """Pin the per-kind shape of a present `stream` side-band: BOOL on
    submit, non-negative INT (not bool) on progress — `isinstance(True,
    int)` is True in Python, so the generic type table alone would
    wave a bool cursor through."""
    s = rec.get("stream")
    if s is None:
        return None
    if kind == "submit":
        if not isinstance(s, bool):
            return "stream"
    elif kind == "progress":
        if isinstance(s, bool) or not isinstance(s, int) or s < 0:
            return "stream"
    return None


def _bad_handoff(rec, kind):
    """Inner-shape check for a present, non-null `handoff` side-band:
    returns a short defect label or None. The outer dict/None check is
    `_FIELD_TYPES`; this pins the inner schema so a fabricated or
    bit-rotted side-band is J008, not a KeyError in the J011 fence."""
    ho = rec.get("handoff")
    if ho is None:
        return None
    if kind == "assign":
        if not isinstance(ho.get("len"), int) or ho["len"] < 0:
            return "len"
        if not isinstance(ho.get("digest"), str):
            return "digest"
    else:  # done
        if not isinstance(ho.get("imported"), int) or ho["imported"] < 0:
            return "imported"
        if not isinstance(ho.get("fallback"), bool):
            return "fallback"
    return None


def _ill_typed(rec, kind):
    """Name of the first ill-typed required (or present optional)
    field, or None."""
    for field in _REQUIRED[kind]:
        if not isinstance(rec[field], _FIELD_TYPES[field]):
            return field
    for field in _OPTIONAL.get(kind, ()):
        if field in rec and not isinstance(rec[field],
                                           _FIELD_TYPES[field]):
            return field
    bad = _bad_stream(rec, kind)
    if bad is not None:
        return bad
    return None


class JournalViolation(RuntimeError):
    """Raised by the `PADDLE_TPU_AUDIT_JOURNAL=1` close() audit when
    the live journal fails the protocol DFA. Carries the diagnostics."""

    def __init__(self, path: str, diagnostics: List[Diagnostic]):
        from .diagnostics import format_diag

        self.diagnostics = list(diagnostics)
        super().__init__(
            "journal %s violates the request protocol (%d finding%s):"
            "\n  %s" % (path, len(self.diagnostics),
                        "" if len(self.diagnostics) == 1 else "s",
                        "\n  ".join(format_diag(d)
                                    for d in self.diagnostics)))


class _Rid(object):
    """DFA state for one request id."""

    __slots__ = ("state", "assign", "assign_version", "progress",
                 "terminal_line", "hwm", "taint", "n_assigns",
                 "assign_handoff", "progress_at_assign", "prompt_len")

    def __init__(self):
        self.state = "open"          # open -> terminal
        self.assign: Optional[Tuple[str, int, int]] = None
        # weights_version side-band of the latest assignment (None =
        # unversioned): the J009 version fence's reference value
        self.assign_version: Optional[int] = None
        self.progress: List[int] = []
        self.terminal_line = 0
        # handoff fence (J011): how many assigns this rid has
        # seen (a package on the FIRST one is fabricated), the latest
        # assignment's handoff side-band, the journaled-progress length
        # when that assignment landed (a done beyond it means the
        # holder actually ran), and the submit spec's prompt length
        # (bounds what a package could legally cover)
        self.n_assigns = 0
        self.assign_handoff: Optional[dict] = None
        self.progress_at_assign = 0
        self.prompt_len = 0
        # taint fence: the high-water mark of journaled
        # progress (never lowered — an integrity truncation lowers the
        # ACCUMULATION, not the mark) and the active taint window
        # [from, upto). Progress below the mark is a re-decode, legal
        # ONLY inside the window (J010).
        self.hwm = 0
        self.taint: Optional[Tuple[int, int]] = None


def _iter_records(path: str):
    """(lineno, record-or-None, raw) — a None record is a parse
    failure; final-line failures are torn tails (tolerated), earlier
    ones are J008 (the caller decides, mirroring RequestJournal._read's
    torn-tail rule without raising)."""
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                yield lineno, None, line
                continue
            if not isinstance(rec, dict):
                yield lineno, None, line
                continue
            yield lineno, rec, line


def verify_records(records, path_label: str = "<journal>",
                   expect_closed: bool = False) -> List[Diagnostic]:
    """Run the protocol DFA over an iterable of (lineno, record) pairs
    (already-parsed journal records). The library half of
    `verify_journal`, reusable over in-memory record lists (tests, the
    explorer's invariant probes)."""
    diags: List[Diagnostic] = []
    rids: Dict[int, _Rid] = {}
    # quarantined (replica, incarnation) -> integrity-record line: any
    # later record naming the pair is J010 (the fleet kills the
    # incarnation at the trip; nothing legitimate can follow)
    quarantined: Dict[Tuple[str, int], int] = {}

    def diag(code, lineno, rid, detail, msg):
        # a malformed record's rid may be any JSON value — the symbol
        # must describe it, never crash the describer
        sym = "rid%d" % rid if isinstance(rid, int) else "journal"
        diags.append(make(code, path_label, lineno, sym, detail, msg))

    first_record = True
    for lineno, rec in records:
        kind = rec.get("kind")
        if kind not in _KINDS:
            diag("J008", lineno, rec.get("rid"), "kind:%r" % (kind,),
                 "unknown record kind %r" % (kind,))
            first_record = False
            continue
        missing = [k for k in _REQUIRED[kind] if k not in rec]
        if missing:
            diag("J008", lineno, rec.get("rid"),
                 "%s:missing:%s" % (kind, ",".join(missing)),
                 "%s record missing field(s) %s" % (kind,
                                                    ", ".join(missing)))
            first_record = False
            continue
        bad = _ill_typed(rec, kind)
        if bad is not None:
            rid = rec["rid"] if isinstance(rec.get("rid"), int) else None
            diag("J008", lineno, rid, "%s:ill-typed:%s" % (kind, bad),
                 "%s record field %r has type %s, expected %s"
                 % (kind, bad, type(rec[bad]).__name__,
                    "/".join(t.__name__ for t in _FIELD_TYPES[bad])))
            first_record = False
            continue
        if kind == "meta":
            if not first_record:
                diag("J008", lineno, None, "meta-mid-file",
                     "compaction meta record at line %d is not at the "
                     "file head: compaction rewrites the WHOLE file, a "
                     "mid-file meta means two histories were glued "
                     "together" % lineno)
            first_record = False
            continue
        first_record = False
        if kind == "integrity":
            # the quarantine record: no rid of its own
            if not isinstance(rec["replica"], str) \
                    or not isinstance(rec["incarnation"], int):
                diag("J008", lineno, None, "integrity:ill-typed:holder",
                     "integrity record needs a concrete (replica, "
                     "incarnation) — got (%r, %r)"
                     % (rec["replica"], rec["incarnation"]))
                continue
            holder2 = (rec["replica"], rec["incarnation"])
            for rid_s in sorted(rec["taint"]):
                window = rec["taint"][rid_s]
                try:
                    trid = int(rid_s)
                except (TypeError, ValueError):
                    trid = None
                if (trid is None or not isinstance(window, list)
                        or len(window) != 2
                        or not all(isinstance(w, int) for w in window)):
                    diag("J008", lineno, None,
                         "integrity:ill-typed:taint",
                         "integrity taint entry %r -> %r is not "
                         "rid -> [from, upto]" % (rid_s, window))
                    continue
                frm, upto = window
                st = rids.get(trid)
                if st is None:
                    diag("J010", lineno, trid, "taint:unknown-rid",
                         "integrity record taints rid %d that was "
                         "never submitted in this file" % trid)
                    continue
                if st.state == "terminal":
                    diag("J010", lineno, trid, "taint:terminal",
                         "integrity record taints rid %d after its "
                         "terminal record (line %d) — a verdict's "
                         "tokens cannot be retroactively tainted"
                         % (trid, st.terminal_line))
                    continue
                if frm < 0 or frm > upto:
                    diag("J010", lineno, trid, "taint:ill-formed",
                         "integrity taint window [%d, %d) for rid %d "
                         "is ill-formed" % (frm, upto, trid))
                    continue
                if frm > len(st.progress):
                    diag("J010", lineno, trid, "taint:past-progress",
                         "integrity taint window for rid %d opens at "
                         "token %d but only %d progress token(s) are "
                         "journaled — the verified prefix cannot "
                         "exceed what was journaled"
                         % (trid, frm, len(st.progress)))
                    continue
                # truncate the ACCUMULATION to the verified prefix;
                # the high-water mark keeps the pre-taint length so a
                # later progress below it is recognized as re-decode
                st.hwm = max(st.hwm, len(st.progress), upto)
                st.progress = st.progress[:frm]
                st.taint = (frm, upto)
            quarantined[holder2] = lineno
            continue
        rid = rec["rid"]
        st = rids.get(rid)
        if kind == "submit":
            if st is not None:
                code = ("J003" if st.state == "terminal" else "J001")
                diag(code, lineno, rid, "resubmit",
                     "duplicate submit for rid %d (already %s)"
                     % (rid, st.state))
                continue
            st = rids[rid] = _Rid()
            prompt = rec["spec"].get("prompt")
            if isinstance(prompt, list):
                st.prompt_len = len(prompt)
            continue
        if st is None:
            diag("J001", lineno, rid, "orphan:%s" % kind,
                 "%s record for rid %d that was never submitted in "
                 "this file" % (kind, rid))
            # keep tracking, applying this record's state effects
            # WITHOUT further checks: one orphan is one finding, not a
            # cascade of secondary fence/terminal violations
            st = rids[rid] = _Rid()
            if kind == "assign":
                st.assign = (rec["replica"], rec["incarnation"],
                             rec["gen"])
                st.assign_version = rec.get("weights_version")
                st.n_assigns = 1
                if _bad_handoff(rec, "assign") is None:
                    st.assign_handoff = rec.get("handoff")
            elif kind == "progress":
                st.progress.extend(rec["tokens"])
                st.hwm = len(st.progress)
            else:
                st.state = "terminal"
                st.terminal_line = lineno
            continue
        if st.state == "terminal":
            code = "J002" if kind in _TERMINAL else "J003"
            diag(code, lineno, rid, "%s-after-terminal" % kind,
                 "%s record for rid %d after its terminal record "
                 "(line %d): the DFA allows exactly one verdict"
                 % (kind, rid, st.terminal_line))
            continue
        if kind == "assign":
            if (rec["replica"], rec["incarnation"]) in quarantined:
                diag("J010", lineno, rid,
                     "assign:quarantined:%s" % (rec["replica"],),
                     "assign of rid %d to (%r, incarnation %r) AFTER "
                     "that incarnation's integrity event (line %d) — "
                     "the fleet kills a tripped incarnation; nothing "
                     "may be assigned to it again"
                     % (rid, rec["replica"], rec["incarnation"],
                        quarantined[(rec["replica"],
                                     rec["incarnation"])]))
            ho = rec.get("handoff")
            bad_ho = _bad_handoff(rec, "assign")
            if bad_ho is not None:
                diag("J008", lineno, rid, "assign:handoff:%s" % bad_ho,
                     "assign handoff side-band for rid %d has an "
                     "ill-formed %r field (%r) — expected "
                     '{"len": int >= 0, "digest": str}'
                     % (rid, bad_ho, ho.get(bad_ho)))
                ho = None
            elif ho is not None:
                # the J011 handoff fence, assign half.
                # journaled progress with no assign seen yet is the
                # compacted/restart consolidated form — a prior holder
                # existed, so its re-emitted package has a source
                if st.n_assigns == 0 and not st.progress:
                    diag("J011", lineno, rid, "handoff:first-assign",
                         "assign of rid %d carries a handoff package "
                         "on its FIRST assignment — packages only "
                         "attach at re-route (migration/failover); an "
                         "admission-time package has no source" % rid)
                cap = st.prompt_len + len(st.progress)
                if ho["len"] > cap:
                    diag("J011", lineno, rid, "handoff:overrun",
                         "assign handoff for rid %d claims %d "
                         "package token(s) but only %d (prompt + "
                         "journaled progress) existed to close — the "
                         "package describes blocks the source never "
                         "had" % (rid, ho["len"], cap))
            st.assign = (rec["replica"], rec["incarnation"], rec["gen"])
            st.assign_version = rec.get("weights_version")
            st.assign_handoff = ho
            st.progress_at_assign = len(st.progress)
            st.n_assigns += 1
            continue
        if kind == "progress":
            holder = (rec["replica"], rec["incarnation"], rec["gen"])
            if rec["replica"] is None or rec["replica"] == _RESTART:
                # compaction's consolidated form / the restart resume
                # prefix: both precede (or replace) any assignment
                pass
            elif st.assign is None:
                diag("J006", lineno, rid, "progress:%s" % rec["replica"],
                     "progress for rid %d from %r with no assignment "
                     "in effect" % (rid, rec["replica"]))
            elif holder != st.assign:
                diag("J004", lineno, rid,
                     "progress:%s" % (rec["replica"],),
                     "progress for rid %d from %r (incarnation %r, gen "
                     "%r) but the latest assignment is %r — a stale "
                     "holder's tokens were accepted past the lease "
                     "fence" % (rid, rec["replica"], rec["incarnation"],
                                rec["gen"], (st.assign,)))
            if rec["replica"] is not None and rec["replica"] != _RESTART \
                    and (rec["replica"], rec["incarnation"]) in quarantined:
                diag("J010", lineno, rid,
                     "progress:quarantined:%s" % (rec["replica"],),
                     "progress for rid %d from (%r, incarnation %r) "
                     "AFTER that incarnation's integrity event (line "
                     "%d) — a quarantined holder's tokens were "
                     "accepted" % (rid, rec["replica"],
                                   rec["incarnation"],
                                   quarantined[(rec["replica"],
                                                rec["incarnation"])]))
            # the taint-fence re-decode audit: progress
            # below the high-water mark journals token indices a
            # PREVIOUS holder already journaled. That is legal only
            # for indices INSIDE a journaled taint window — the
            # zero-re-decode rule everywhere else (both ends checked:
            # a resume below `from` re-decodes VERIFIED tokens, a span
            # past `upto` re-decodes untainted ones)
            L = len(st.progress)
            hi = min(L + len(rec["tokens"]), st.hwm)
            if hi > L and (st.taint is None or L < st.taint[0]
                           or hi > st.taint[1]):
                diag("J010", lineno, rid, "redecode-outside-taint",
                     "progress for rid %d re-decodes token indices "
                     "[%d, %d) (high-water mark %d) outside the "
                     "journaled taint window (%r) — only tainted "
                     "tokens may ever re-decode"
                     % (rid, L, hi, st.hwm, st.taint))
            st.progress.extend(rec["tokens"])
            st.hwm = max(st.hwm, len(st.progress))
            cur = rec.get("stream")
            if isinstance(cur, int) and not isinstance(cur, bool) \
                    and cur != len(st.progress):
                # the wire side-band's one semantic promise: the
                # cursor IS the accumulation after this
                # delta — what a restarted front door may already
                # have delivered. A drifting cursor is an ill-shaped
                # side-band (J008), and acting on it would re-send
                # or skip streamed tokens.
                diag("J008", lineno, rid, "stream-cursor",
                     "progress for rid %d carries stream cursor %d "
                     "but the accumulated journaled progress is %d "
                     "token(s) — a resumed stream would re-deliver "
                     "or skip tokens" % (rid, cur, len(st.progress)))
            continue
        # terminal kinds
        st.state = "terminal"
        st.terminal_line = lineno
        if kind == "done" and rec["replica"] != _RESTART \
                and (rec["replica"], rec["incarnation"]) in quarantined:
            # "a done whose assignment predates the replica's
            # integrity event": the quarantined incarnation's verdict
            # landed past the fence
            diag("J010", lineno, rid,
                 "done:quarantined:%s" % (rec["replica"],),
                 "done for rid %d from (%r, incarnation %r) AFTER "
                 "that incarnation's integrity event (line %d) — its "
                 "assignment predates the quarantine, the verdict "
                 "must be refused"
                 % (rid, rec["replica"], rec["incarnation"],
                    quarantined[(rec["replica"], rec["incarnation"])]))
        if kind == "done":
            holder = (rec["replica"], rec["incarnation"], rec["gen"])
            if rec["replica"] == _RESTART and st.assign is None:
                pass  # completed straight from the restart prefix
            elif st.assign is None:
                diag("J006", lineno, rid, "done:%s" % (rec["replica"],),
                     "done for rid %d from %r with no assignment in "
                     "effect" % (rid, rec["replica"]))
            elif holder != st.assign:
                diag("J004", lineno, rid, "done:%s" % (rec["replica"],),
                     "done for rid %d from %r (incarnation %r, gen %r) "
                     "but the latest assignment is %r — a zombie "
                     "holder's completion was accepted"
                     % (rid, rec["replica"], rec["incarnation"],
                        rec["gen"], (st.assign,)))
            dv = rec.get("weights_version")
            if dv is not None and st.assign is not None \
                    and st.assign_version is not None \
                    and dv != st.assign_version:
                # the live-rollout version fence: the
                # verdict must come from the weights the latest
                # assignment promised — a mismatch means tokens from
                # two weight versions were mixed into one response
                diag("J009", lineno, rid, "done-version",
                     "done for rid %d records weights_version %d but "
                     "its latest assignment carries version %d — a "
                     "mixed-version output crossed the rollout fence"
                     % (rid, dv, st.assign_version))
            # the J011 handoff fence, done half: every
            # shipped package traces to a verified import or a counted
            # fallback — silence is a protocol violation
            out = rec.get("handoff")
            bad_ho = _bad_handoff(rec, "done")
            if bad_ho is not None:
                diag("J008", lineno, rid, "done:handoff:%s" % bad_ho,
                     "done handoff outcome for rid %d has an "
                     "ill-formed %r field (%r) — expected "
                     '{"imported": int >= 0, "fallback": bool}'
                     % (rid, bad_ho, out.get(bad_ho)))
            elif out is not None and st.assign_handoff is None:
                diag("J011", lineno, rid, "handoff:unshipped",
                     "done for rid %d reports a handoff outcome but "
                     "its latest assignment shipped no package — an "
                     "import was claimed for a transfer that never "
                     "happened" % rid)
            elif out is not None \
                    and out["imported"] > st.assign_handoff["len"]:
                diag("J011", lineno, rid, "handoff:over-import",
                     "done for rid %d claims %d imported token(s) but "
                     "its assignment's package carried only %d"
                     % (rid, out["imported"],
                        st.assign_handoff["len"]))
            elif out is None and st.assign_handoff is not None \
                    and st.assign is not None and holder == st.assign \
                    and len(rec["tokens"]) > st.progress_at_assign:
                diag("J011", lineno, rid, "handoff:unaccounted",
                     "done for rid %d from the holder that received a "
                     "%d-token handoff package reports no outcome — "
                     "the package must be accounted as a verified "
                     "import or a counted fallback, never silence"
                     % (rid, st.assign_handoff["len"]))
        if kind in ("done", "expired", "cancelled"):
            # no empty-progress exemption: the fleet journals EVERY
            # emitted token as a progress delta before the terminal
            # (the re-decode-zero audit depends on it), so a done
            # with tokens but no journaled progress is exactly the
            # never-journaled defect this code names. `cancelled`
            # is held to the same bar: its tokens are the
            # journaled prefix at cancel time, taken under the same
            # lock the progress mirror updates under
            if list(rec["tokens"]) != st.progress:
                diag("J005", lineno, rid, "%s-tokens" % kind,
                     "%s tokens for rid %d (%d token(s)) differ from "
                     "the accumulated journaled progress (%d token(s)) "
                     "— a token was re-decoded, double-prepended, or "
                     "never journaled" % (kind, rid, len(rec["tokens"]),
                                          len(st.progress)))
    if expect_closed:
        for rid in sorted(rids):
            st = rids[rid]
            if st.state != "terminal":
                diags.append(make(
                    "J007", path_label, 0, "rid%d" % rid, "open",
                    "rid %d is still open at end of journal — close() "
                    "promises every journaled rid a terminal verdict"
                    % rid))
    diags.sort(key=lambda d: (d.line, d.code, d.symbol))
    return diags


def verify_journal(path: str,
                   expect_closed: bool = False) -> List[Diagnostic]:
    """Verify a `RequestJournal` file against the protocol DFA.
    Returns the J-coded findings (empty = the journal is a valid
    history). Tolerates a torn final line; anything unparseable
    earlier is J008, not an exception — an auditor must be able to
    describe a corrupt journal, not crash on it."""
    if not os.path.exists(path):
        raise FileNotFoundError("no such journal: %r" % path)
    label = rel_path(path)
    parsed: List[Tuple[int, dict]] = []
    torn: Optional[Tuple[int, str]] = None
    diags: List[Diagnostic] = []
    for lineno, rec, raw in _iter_records(path):
        if torn is not None:
            # an unparseable line FOLLOWED by more content is not a
            # torn tail — it is mid-file corruption
            diags.append(make(
                "J008", label, torn[0], "journal", "corrupt-line",
                "unparseable record at line %d is not a torn tail "
                "(records follow it)" % torn[0]))
            torn = None
        if rec is None:
            torn = (lineno, raw)
            continue
        parsed.append((lineno, rec))
    diags.extend(verify_records(parsed, path_label=label,
                                expect_closed=expect_closed))
    diags.sort(key=lambda d: (d.line, d.code, d.symbol))
    return diags
