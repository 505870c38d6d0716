"""The port's training sentinel (paddle_tpu_torch.distributed.sentinel)
against the JAX package's: over one seeded loss trace the two
DivergenceDetectors give the same verdicts and states, and the two
TrainingSentinels, driven through one scripted run (checkpoints, loader
cursors over the same shards, NaNs and spikes), make the same trip
decisions, set aside the same step dirs and write the same
`sentinel.json` and quarantine journal; either package resumes under
the state the other wrote. The port's Supervisor classifies sentinel
rollbacks and crashes as the JAX package's does. Verdicts, decisions
and files match exactly: there is no tolerance."""

import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.data as jdata
import paddle_tpu.distributed.checkpoint as jckpt
import paddle_tpu.distributed.sentinel as jsent
import paddle_tpu_torch.data as tdata
import paddle_tpu_torch.distributed.checkpoint as tckpt
import paddle_tpu_torch.distributed.sentinel as tsent
from paddle_tpu_torch.distributed import Supervisor

SIDES = {"jax": (jsent, jckpt, jdata), "torch": (tsent, tckpt, tdata)}


class _Scope(dict):
    def get(self, name):
        return dict.get(self, name)

    def set(self, name, value):
        self[name] = value


def _trace(seed, n=60):
    """A loss trace with a slow decay, noise, transient and sustained
    spikes, NaN and inf; grad norms with one NaN."""
    rng = np.random.RandomState(seed)
    loss = list(2.0 * np.exp(-np.arange(n) / 30.0)
                + 0.05 * rng.rand(n))
    for k in (9, 20, 21, 22, 40):
        loss[k] *= 50.0
    loss[30] = float("nan")
    loss[47] = float("inf")
    grad = [float(g) for g in rng.rand(n)]
    grad[35] = float("nan")
    return [float(x) for x in loss], grad


@pytest.mark.parametrize("kw", [{}, {"hysteresis": 1, "warmup": 2},
                                {"spike_factor": 2.0, "hysteresis": 3,
                                 "ewma_alpha": 0.5, "warmup": 0}])
def test_detector_verdicts_match_on_one_trace(kw):
    loss, grad = _trace(0)
    j = jsent.DivergenceDetector(**kw)
    t = tsent.DivergenceDetector(**kw)
    tt = tsent.DivergenceDetector(**kw)  # fed tensors
    for x, g in zip(loss, grad):
        v = j.observe(x, grad_norm=g)
        assert t.observe(x, grad_norm=g) == v
        assert tt.observe(torch.tensor(x, dtype=torch.float64),
                          grad_norm=torch.tensor(g)) == v
        assert t.state_dict() == j.state_dict()
        assert t.suspect == j.suspect
    t2 = tsent.DivergenceDetector(**kw)
    t2.load_state_dict(json.loads(json.dumps(j.state_dict())))
    assert t2.ewma == j.ewma


def test_observe_reads_a_tensor_once(tmp_path):
    """TrainingSentinel.observe takes the loss the loop already reads
    back: a tensor is read with one .item() per step."""
    reads = []
    s = tsent.TrainingSentinel(str(tmp_path), promote_after=1,
                               detector=tsent.DivergenceDetector(warmup=1))
    for step, x in enumerate([1.0, 1.1, float("nan")], 1):
        t = torch.tensor(x)
        item = t.item
        t.item = lambda item=item: reads.append(1) or item()
        out = s.observe(step, t)
    assert len(reads) == 3
    assert out["verdict"] == "nonfinite"


def _shards(tmp_path, n_shards=2, records=48, per_chunk=8):
    paths, rid = [], 0
    for s in range(n_shards):
        p = str(tmp_path / ("s%d.rs" % s))
        with tdata.ShardWriter(p, records_per_chunk=per_chunk) as w:
            for _ in range(records):
                w.write(pickle.dumps((rid, float(rid))))
                rid += 1
        paths.append(p)
    return paths


def _script(side, root, paths, steps, resume=None):
    """Drive one package's sentinel through a scripted run: a loader over
    the shards supplies the cursors, a checkpoint every 2 steps, the
    trace's losses. `resume` is the loader and detector state an earlier
    part of the run left. Returns (decisions, sentinel, states)."""
    sent, ckpt, data = SIDES[side]
    ck = os.path.join(root, "ckpt")
    q = os.path.join(root, "q.jsonl")
    ds = data.ShardedDataset(paths, decode_fn=pickle.loads, seed=3,
                             quarantine_path=q)
    dl = data.DataLoader(ds, batch_size=6, num_workers=0)
    detector = sent.DivergenceDetector(hysteresis=1, warmup=2)
    if resume is not None:
        dl.load_state_dict(json.loads(json.dumps(resume["loader"])))
        detector.load_state_dict(json.loads(json.dumps(resume["detector"])))
    sentinel = sent.TrainingSentinel(
        ck, quarantine_path=q, dataset=ds, promote_after=3,
        rollback_budget=2, quarantine_rounds_max=2, detector=detector)
    loss, _grad = _trace(1, n=80)
    scope = _Scope()
    decisions = []
    it = iter(dl)
    for step in steps:
        try:
            next(it)
        except StopIteration:
            it = iter(dl)
            next(it)
        cur = dl.state_dict()
        decisions.append(sentinel.observe(step, loss[step], cursor=cur))
        if step % 2 == 0:
            scope.set("w", np.full(3, float(step)))
            ckpt.save_checkpoint(scope, ck, step=step, keep_last=10,
                                 protect=sentinel.known_good_step)
            sentinel.on_checkpoint(step, cursor=cur)
    states = {"loader": dl.state_dict(), "detector": detector.state_dict()}
    dl.close()
    return decisions, sentinel, states


def _files(root):
    ck = os.path.join(root, "ckpt")
    with open(os.path.join(ck, "sentinel.json")) as f:
        state = json.load(f)
    q = os.path.join(root, "q.jsonl")
    journal = open(q).read() if os.path.exists(q) else None
    return state, journal, sorted(os.listdir(ck))


def test_sentinel_decisions_and_files_match(tmp_path):
    paths = _shards(tmp_path)
    out = {}
    for side in SIDES:
        root = str(tmp_path / side)
        os.makedirs(root)
        decisions, s, _ = _script(side, root, paths, range(1, 50))
        out[side] = (decisions, s.summary(), _files(root))
    assert out["torch"] == out["jax"]
    decisions = [d for d in out["torch"][0] if d is not None]
    assert {d["action"] for d in decisions} >= {"rollback", "quarantine"}
    assert out["torch"][2][1]  # something was quarantined
    assert any(n.endswith(".diverged") for n in out["torch"][2][2])


@pytest.mark.parametrize("first,second", [("jax", "torch"),
                                          ("torch", "jax")])
def test_sentinel_resumes_under_the_others_state(tmp_path, first, second):
    """One package runs the first half, the other resumes on the same
    checkpoint dir, sentinel.json, quarantine journal and loader cursor:
    the run's decisions and files equal the JAX package's whole run."""
    paths = _shards(tmp_path)
    ref = str(tmp_path / "ref")
    os.makedirs(ref)
    want, s, _ = _script("jax", ref, paths, range(1, 50))
    mixed = str(tmp_path / "mixed")
    os.makedirs(mixed)
    d1, _s, states = _script(first, mixed, paths, range(1, 25))
    d2, s2, _ = _script(second, mixed, paths, range(25, 50), resume=states)
    assert d1 + d2 == want
    assert s2.summary() == s.summary()
    assert _files(mixed) == _files(ref)
    assert tsent.known_good_step(os.path.join(mixed, "ckpt")) == \
        jsent.known_good_step(os.path.join(ref, "ckpt"))


def test_chunks_consumed_matches(tmp_path):
    paths = _shards(tmp_path, n_shards=3, records=20, per_chunk=6)
    q = str(tmp_path / "q.jsonl")
    jsent.quarantine_chunks(q, [4])
    dsj = jdata.ShardedDataset(paths, seed=7, quarantine_path=q)
    dst = tdata.ShardedDataset(paths, seed=7, quarantine_path=q)
    rng = np.random.RandomState(0)
    for _ in range(200):
        e0, e1 = sorted(rng.randint(0, 3, 2))
        a = {"epoch": int(e0), "pos": int(rng.randint(0, dst.num_chunks)),
             "offset": int(rng.randint(0, 7))}
        b = {"epoch": int(e1), "pos": int(rng.randint(0, dst.num_chunks)),
             "offset": int(rng.randint(0, 7))}
        assert tsent.chunks_consumed(dst, a, b) == \
            jsent.chunks_consumed(dsj, a, b)
    assert tsent.chunks_consumed(dst, None, None) == []


def test_supervisor_classifies_sentinel_rollbacks(tmp_path):
    """Exit code 75 is an orderly rollback: budgeted on its own counter,
    never a rapid failure, reason-tagged, and the reason reaches the
    replacement as PADDLE_RESTART_REASON."""
    log = tmp_path / "reasons.txt"
    script = ("import os, sys;"
              "open(%r, 'a').write("
              "os.environ.get('PADDLE_RESTART_REASON', '?') + chr(10));"
              "sys.exit(75)" % str(log))
    sup = Supervisor(lambda wid: [sys.executable, "-c", script], ["w0"],
                     restart_backoff_s=0.01, sentinel_rollback_max=3,
                     min_uptime_s=1e9)
    report = sup.run(deadline_s=60)
    w = report["workers"]["w0"]
    assert w["abandoned"] and w["sentinel_rollbacks"] == 3
    assert w["rapid_failures"] == 0
    assert w["restart_reasons"] == ["sentinel_rollback"] * 3
    assert log.read_text().splitlines() == \
        ["none", "sentinel_rollback", "sentinel_rollback"]
    assert tsent.SENTINEL_EXIT_CODE == jsent.SENTINEL_EXIT_CODE == 75


def test_supervisor_crash_loop_abandons_and_keeps_known_good(tmp_path):
    """Crashes are crashes (rapid ones abandon the worker after
    restart_max), and the checkpoint GC after each restart never takes
    the sentinel's known-good step, read from a JAX sentinel.json."""
    ck = str(tmp_path / "ck")
    scope = _Scope()
    for step in (1, 2, 3, 4, 5):
        scope.set("w", np.full(2, float(step)))
        tckpt.save_checkpoint(scope, ck, step=step, keep_last=10)
    s = jsent.TrainingSentinel(ck, promote_after=1,
                               detector=jsent.DivergenceDetector(warmup=1))
    s.on_checkpoint(2)
    s.observe(3, 1.0)
    assert tsent.known_good_step(ck) == 2
    sup = Supervisor(lambda wid: [sys.executable, "-c",
                                  "raise SystemExit(9)"],
                     ["w0"], restart_backoff_s=0.01, restart_max=2,
                     min_uptime_s=1e9, ckpt_dir_for=lambda wid: ck,
                     ckpt_keep_last=1)
    report = sup.run(deadline_s=60)
    w = report["workers"]["w0"]
    assert w["abandoned"] and w["rapid_failures"] == 2
    assert w["sentinel_rollbacks"] == 0
    assert w["restart_reasons"] == ["crash", "crash"]
    assert [st for st, _ in tckpt._list_step_dirs(ck)] == [5, 2]
