"""The port's journal verifier (paddle_tpu_torch.analysis.protocol_lint)
against the JAX package's: both report the same J-codes, with the same
anchors and messages, on every crafted journal of
tests/test_protocol_analysis.py (each of those tests runs here with its
verifier calls answered by both packages and compared), and on journals
written by either package's fleet, whole and corrupted. Exact."""

import inspect
import json

import numpy as np
import pytest

import test_protocol_analysis as corpus
from paddle_tpu.analysis import protocol_lint as jlint
from paddle_tpu_torch.analysis import protocol_lint as tlint

_SKIP_NAMES = ("run_schedule", "explore", "_mini_fleet", "_cli",
               "run_all", "mutants")


def _crafted():
    """The corpus tests that verify crafted journals (not the explorer,
    the fleet audit or the CLI)."""
    out = []
    for name, fn in sorted(vars(corpus).items()):
        if not name.startswith("test_") or not callable(fn):
            continue
        src = inspect.getsource(fn)
        if ("verify_journal" in src or "verify_records" in src) and \
                not any(s in src for s in _SKIP_NAMES):
            out.append(name)
    return out


def _sig(diags):
    return [(d.code, d.path, d.line, d.symbol, d.detail, d.message,
             d.severity) for d in diags]


def _both(name):
    jfn, tfn = getattr(jlint, name), getattr(tlint, name)

    def run(*a, **kw):
        want = jfn(*a, **kw)
        got = tfn(*a, **kw)
        assert _sig(got) == _sig(want)
        return want

    return run


CRAFTED = _crafted()


def test_the_corpus_is_found():
    assert len(CRAFTED) >= 30
    for name in ("test_j001_orphan_progress", "test_j009_version_fence",
                 "test_j011_handoff_overrun",
                 "test_stream_cursor_drift_is_j008",
                 "test_compacted_journal_passes_the_dfa"):
        assert name in CRAFTED


@pytest.mark.parametrize("name", CRAFTED)
def test_same_findings_on_the_crafted_corpus(name, tmp_path, monkeypatch):
    monkeypatch.setattr(corpus, "verify_journal", _both("verify_journal"))
    monkeypatch.setattr(corpus, "verify_records", _both("verify_records"))
    fn = getattr(corpus, name)
    kw = {"tmp_path": tmp_path} if "tmp_path" in \
        inspect.signature(fn).parameters else {}
    fn(**kw)


def test_codes_table_names_every_j_code():
    from paddle_tpu.analysis.diagnostics import CODES as JCODES
    from paddle_tpu_torch.analysis.diagnostics import CODES as TCODES

    for code, entry in JCODES.items():
        if code.startswith("J"):
            assert TCODES[code] == entry
    assert TCODES["J011"] == ("handoff-fence", "error")


# --- journals of real fleets -------------------------------------------

def _port_fleet_journal(path, kill):
    """A small port fleet (two replicas on the CPU) serving six mixed
    requests, one replica lost mid-decode when `kill`."""
    import torch

    from paddle_tpu_torch.distributed.fault_injection import FaultInjector
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.serving import ServingFleet

    cfg = T.TransformerConfig(vocab=64, dim=32, heads=4, layers=2,
                              max_len=64)
    params = T.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    inj = FaultInjector("exc@4" if kill else "")
    fleet = ServingFleet(
        params, cfg, n_replicas=2, journal_path=path,
        heartbeat_timeout_s=120.0, journal_compact_every=None,
        engine_kw={"max_slots": 2, "device": "cpu",
                   "prefix_cache_tokens": 64},
        engine_kw_for=lambda i: {"fault_injector": inj} if i == 0 else {})
    rng = np.random.RandomState(0)
    try:
        hs = [fleet.submit(rng.randint(0, 64, 9).astype(np.int32), 8,
                           temperature=0.8 if i % 2 else 0.0, seed=i)
              for i in range(6)]
        for h in hs:
            h.result(timeout=120)
    finally:
        fleet.close()
    return path


def _jax_fleet_journal(path, kill):
    import jax

    from paddle_tpu.distributed.fault_injection import FaultInjector
    from paddle_tpu.models import transformer as J
    from paddle_tpu.serving import ServingFleet

    cfg = J.TransformerConfig(vocab=64, dim=32, heads=4, layers=2,
                              max_len=64)
    params = J.init_params(cfg, jax.random.PRNGKey(0))
    inj = FaultInjector("exc@4" if kill else "")
    fleet = ServingFleet(
        params, cfg, n_replicas=2, journal_path=path,
        heartbeat_timeout_s=120.0, journal_compact_every=None,
        engine_kw={"max_slots": 2, "prefix_cache_tokens": 64,
                   "paged_kernel": "gather"},
        engine_kw_for=lambda i: {"fault_injector": inj} if i == 0 else {})
    rng = np.random.RandomState(0)
    try:
        hs = [fleet.submit(rng.randint(0, 64, 9).astype(np.int32), 8,
                           temperature=0.8 if i % 2 else 0.0, seed=i)
              for i in range(6)]
        for h in hs:
            h.result(timeout=300)
    finally:
        fleet.close()
    return path


@pytest.fixture(scope="module")
def fleet_journals(tmp_path_factory):
    d = tmp_path_factory.mktemp("fleet_journals")
    return {(side, kill): maker(str(d / ("%s_%d.jsonl" % (side, kill))),
                                kill)
            for side, maker in (("torch", _port_fleet_journal),
                                ("jax", _jax_fleet_journal))
            for kill in (False, True)}


def _rewrite(src, dst, edit):
    recs = [json.loads(line) for line in open(src) if line.strip()]
    with open(dst, "w") as f:
        for r in edit(recs):
            f.write(json.dumps(r) + "\n")
    return dst


def _drop_last_done(recs):
    i = max(k for k, r in enumerate(recs) if r["kind"] == "done")
    return recs[:i] + recs[i + 1:]


def _double_done(recs):
    i = min(k for k, r in enumerate(recs) if r["kind"] == "done")
    return recs + [recs[i]]


def _bend_tokens(recs):
    out = [dict(r) for r in recs]
    for r in out:
        if r["kind"] == "done" and r["tokens"]:
            r["tokens"] = [(r["tokens"][0] + 1) % 64] + r["tokens"][1:]
            break
    return out


def _orphan(recs):
    return [r for r in recs if not (r["kind"] == "submit"
                                    and r["rid"] == 1)]


EDITS = {"clean": None, "open_at_close": _drop_last_done,
         "duplicate_terminal": _double_done,
         "progress_mismatch": _bend_tokens, "orphan": _orphan}
WANT = {"clean": set(), "open_at_close": {"J007"},
        "duplicate_terminal": {"J002"}, "progress_mismatch": {"J005"},
        "orphan": {"J001"}}


@pytest.mark.parametrize("side", ["jax", "torch"])
@pytest.mark.parametrize("kill", [False, True])
@pytest.mark.parametrize("edit", sorted(EDITS))
def test_same_findings_on_fleet_journals(fleet_journals, tmp_path, side,
                                         kill, edit):
    path = fleet_journals[(side, kill)]
    if EDITS[edit] is not None:
        path = _rewrite(path, str(tmp_path / "edited.jsonl"), EDITS[edit])
    want = jlint.verify_journal(path, expect_closed=True)
    got = tlint.verify_journal(path, expect_closed=True)
    assert _sig(got) == _sig(want)
    assert {d.code for d in got} >= WANT[edit]
    if edit == "clean":
        assert got == []
        kinds = [json.loads(line)["kind"] for line in open(path)]
        assert kinds.count("done") == 6
        assert (kinds.count("assign") > 6) == kill  # failover reassigns


def test_journal_violation_names_the_codes(tmp_path):
    p = corpus._journal(tmp_path, "bad.jsonl",
                        [corpus._submit(0), corpus._done(0, [1])])
    diags = tlint.verify_journal(p, expect_closed=True)
    assert diags and _sig(diags) == _sig(
        jlint.verify_journal(p, expect_closed=True))
    msg = str(tlint.JournalViolation(p, diags))
    assert msg == str(jlint.JournalViolation(
        p, jlint.verify_journal(p, expect_closed=True)))
    assert all(d.code in msg for d in diags)
