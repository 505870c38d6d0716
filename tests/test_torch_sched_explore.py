"""The port's schedule explorer and fleet (paddle_tpu_torch.analysis.
sched_explore over paddle_tpu_torch.serving.fleet) against the JAX
package's: for each of the ten SCENARIOS, the default schedule and the
first schedules of the bounded-preemption sweep (max_preemptions=1) run
in both packages take the same decisions (the same enabled threads and
choice at every step), reach the same per-rid verdicts and tokens and
write the same journal records, wall times aside. Neither reports a
violation; with a protocol mutant re-opened, both find the same
violating schedule. Exact."""

import json
import os

import pytest

import paddle_tpu.serving.fleet as jfleet
import paddle_tpu_torch.serving.fleet as tfleet
from paddle_tpu.analysis import sched_explore as J
from paddle_tpu_torch.analysis import sched_explore as T

NAMES = sorted(J.SCENARIOS)
# schedules run per scenario beyond the default one (each in both)
BRANCHES = 8


def test_the_same_scenarios():
    assert sorted(T.SCENARIOS) == NAMES and len(NAMES) == 10


def _records(path):
    """The journal's records with the wall-clock field taken out."""
    def strip(x):
        if isinstance(x, dict):
            return {k: strip(v) for k, v in x.items()
                    if k != "submit_unix"}
        if isinstance(x, list):
            return [strip(v) for v in x]
        return x

    with open(path) as f:
        return [strip(json.loads(line)) for line in f if line.strip()]


def _verdicts(records):
    """rid -> (terminal kind, tokens) from a journal."""
    return {r["rid"]: (r["kind"], r.get("tokens"))
            for r in records
            if r["kind"] in ("done", "rejected", "expired", "cancelled")}


def _both(name, decisions, tmp_path, tag):
    rj = J.run_schedule(J.SCENARIOS[name](), list(decisions),
                        str(tmp_path / ("%s_jax.jsonl" % tag)))
    rt = T.run_schedule(T.SCENARIOS[name](), list(decisions),
                        str(tmp_path / ("%s_torch.jsonl" % tag)))
    assert rt.trace == rj.trace, "the two fleets chose differently"
    assert rj.violations == [] and rt.violations == []
    jrec, trec = _records(rj.journal_path), _records(rt.journal_path)
    assert _verdicts(trec) == _verdicts(jrec)
    assert trec == jrec
    return rt


def _branches(result, limit):
    """The first one-preemption branches of a run, latest choice point
    first (explore's order at this depth)."""
    schedule = result.schedule
    out = []
    for i in range(len(result.trace) - 1, -1, -1):
        enabled, chosen = result.trace[i]
        for alt in enabled:
            if alt != chosen:
                out.append(tuple(schedule[:i]) + (alt,))
                if len(out) == limit:
                    return out
    return out


@pytest.mark.parametrize("name", NAMES)
def test_default_schedule_matches(name, tmp_path):
    r = _both(name, [], tmp_path, "default")
    assert len(r.trace) > 10
    assert _verdicts(_records(r.journal_path))


@pytest.mark.parametrize("name", NAMES)
def test_preempted_schedules_match(name, tmp_path):
    base = T.run_schedule(T.SCENARIOS[name](), [],
                          str(tmp_path / "base.jsonl"))
    branches = _branches(base, BRANCHES)
    assert branches
    for k, prefix in enumerate(branches):
        _both(name, prefix, tmp_path, "b%02d" % k)


@pytest.mark.parametrize("name", NAMES)
def test_explore_reports_match(name, tmp_path):
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(dj)
    os.makedirs(dt)
    ej = J.explore(J.SCENARIOS[name], str(dj), max_preemptions=1,
                   max_schedules=6)
    et = T.explore(T.SCENARIOS[name], str(dt), max_preemptions=1,
                   max_schedules=6)
    assert et.ok and ej.ok and et.runs == ej.runs == 6
    for fj in sorted(os.listdir(dj)):
        assert _records(str(dt / fj)) == _records(str(dj / fj))


@pytest.mark.parametrize("mutant,scenario", [
    ("superseded_report", "demote_route_back"),
    ("double_reject", "close_race")])
def test_mutants_are_caught_alike(mutant, scenario, tmp_path,
                                  monkeypatch):
    """Each test-only protocol mutant re-opened in both fleets: both
    explorers stop at the same schedule with the same violations."""
    monkeypatch.setattr(jfleet, "_MUTANTS", {mutant})
    monkeypatch.setattr(tfleet, "_MUTANTS", {mutant})
    dj, dt = tmp_path / "jax", tmp_path / "torch"
    os.makedirs(dj)
    os.makedirs(dt)
    ej = J.explore(J.SCENARIOS[scenario], str(dj), max_preemptions=1,
                   max_schedules=64)
    et = T.explore(T.SCENARIOS[scenario], str(dt), max_preemptions=1,
                   max_schedules=64)
    assert not ej.ok and not et.ok and et.runs == ej.runs
    vj, vt = ej.violation, et.violation
    assert vt.schedule == vj.schedule and vt.trace == vj.trace

    def norm(r):
        return [v.replace(r.journal_path, "<journal>")
                for v in r.violations]

    assert norm(vt) == norm(vj)
