"""The port's serving fleet (paddle_tpu_torch/serving/fleet.py) against
the JAX package's, on the CPU at a tiny size.

* Token identity: one trace (a shared header, greedy and sampled
  requests) through port fleets of 1 and 3 replicas, with prefix
  affinity on and off, and through a 3-replica kill drill (replica r0
  crashes mid-decode; its work resumes on survivors from the journal):
  every request's tokens equal the JAX engine's for the same weights,
  nothing is lost, the kill drill makes one failover.
* Verdicts: deadlines (dead on arrival, expired in the queue), cancel,
  FleetSaturated, drain and refill.
* Interchange: journals of either package's fleet recover to the same
  open set and progress in both packages' RequestJournal and verify
  clean in both verifiers; weight sets written by either package's
  save_weights roll onto the other's fleet (a bf16 tree too: the port
  keeps it bf16); a foreign checkpoint is refused with the JAX
  package's RolloutAborted message.
* The engine's fleet knobs (scheduler_hook, weights_version) and the
  subprocess drill (run_fleet_subprocess over tests/torch_fleet_worker.py,
  one worker SIGKILLed mid-decode).

Exact throughout: token streams, verdicts and journal contents match
with no tolerance.
"""

import json
import os
import signal
import sys
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp_
from paddle_tpu.distributed.fault_injection import \
    FaultInjector as JaxInjector
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ServingFleet as JaxFleet
from paddle_tpu.serving import fleet as jfleet_mod
from paddle_tpu.analysis.protocol_lint import verify_journal as jverify
from paddle_tpu.analysis.sched_explore import ScriptEngine
from paddle_tpu_torch.analysis.protocol_lint import verify_journal as tverify
from paddle_tpu_torch.distributed.fault_injection import FaultInjector
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import (DeadlineExceeded, EngineFailed,
                                      FleetSaturated, RequestCancelled,
                                      RequestJournal, RolloutAborted,
                                      SchedulerHook, ServingEngine,
                                      ServingFleet, load_weights,
                                      save_weights)
from paddle_tpu_torch.serving import fleet as tfleet_mod

torch.set_num_threads(2)

HERE = os.path.dirname(os.path.abspath(__file__))
DIMS = dict(vocab=64, max_len=64)
ENGINE = dict(max_slots=3, kv_block_tokens=8, prefill_chunk_tokens=16,
              prefix_cache_tokens=128)


@pytest.fixture(scope="module")
def model():
    return tp_.models(0, **DIMS)


@pytest.fixture(scope="module")
def trace():
    return tp_.trace(1, vocab=DIMS["vocab"])


@pytest.fixture(scope="module")
def jax_tokens(model, trace):
    """The JAX engine's tokens for the trace (one engine, gather form)."""
    jcfg, jp, _, _ = model
    eng = JaxEngine(jp, jcfg, paged_kernel="gather", **ENGINE)
    return tp_.tokens_of(eng, trace)


def _fleet(tp, cfg, n, path=None, **kw):
    engine_kw = dict(ENGINE, device="cpu")
    engine_kw.update(kw.pop("engine_kw", {}))
    return ServingFleet(tp, cfg, n_replicas=n, journal_path=path,
                        heartbeat_timeout_s=120.0,
                        journal_compact_every=None, engine_kw=engine_kw,
                        **kw)


def _serve(fleet, trace, timeout=120):
    hs = [fleet.submit(**r) for r in trace]
    for h in hs:
        h.result(timeout=timeout)
    return hs


@pytest.mark.parametrize("n,affinity,kill", [
    (1, True, False), (3, True, False), (3, False, False),
    (3, True, True)], ids=["n1", "n3", "n3-no-affinity", "n3-kill"])
def test_fleet_tokens_equal_the_jax_engine(model, trace, jax_tokens, n,
                                           affinity, kill, tmp_path):
    _, _, cfg, tp = model
    path = str(tmp_path / "j.jsonl")
    inj = FaultInjector("exc@3" if kill else "")
    fleet = _fleet(tp, cfg, n, path, affinity=affinity,
                   engine_kw_for=lambda i: (
                       {"fault_injector": inj} if i == 0 else {}))
    try:
        hs = _serve(fleet, trace)
        st = fleet.stats()
    finally:
        fleet.close()
    assert [list(h.tokens) for h in hs] == jax_tokens
    assert st["lost"] == 0 and st["duplicate_refused"] == 0
    assert st["completed"] == len(trace)
    assert st["failovers"] == (1 if kill else 0)
    if kill:
        assert st["replicas"][0]["state"] == "dead"
        assert st["resubmitted"] >= 1
    assert tverify(path, expect_closed=True) == []
    assert jverify(path, expect_closed=True) == []
    assert RequestJournal.recover(path) == []
    assert jfleet_mod.RequestJournal.recover(path) == []


def test_fleet_needs_the_card_or_the_cpu_by_name(model):
    _, _, cfg, tp = model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingFleet(tp, cfg, n_replicas=1, engine_kw={})
    with pytest.raises(ValueError, match="kv_block_tokens"):
        ServingFleet(tp, cfg, n_replicas=1,
                     engine_kw={"device": "cpu", "prefix_block_tokens": 8})


def test_deadlines_expire_with_a_verdict(model, tmp_path):
    _, _, cfg, tp = model
    path = str(tmp_path / "j.jsonl")
    fleet = _fleet(tp, cfg, 1, path, engine_kw={"max_slots": 1})
    p = np.arange(1, 9, dtype=np.int32)
    try:
        with pytest.raises(DeadlineExceeded):
            fleet.submit(p, 4, deadline_s=0.0)  # dead on arrival
        long = fleet.submit(p, 40)
        late = fleet.submit(p, 4, deadline_s=0.005)  # behind `long`
        with pytest.raises(DeadlineExceeded) as e:
            late.result(timeout=120)
        assert e.value.rid == late.rid
        assert len(long.result(timeout=120)) == len(p) + 40
        st = fleet.stats()
        assert st["expired"] == 1 and st["expired_on_arrival"] == 1
        assert st["lost"] == 0
    finally:
        fleet.close()
    kinds = [json.loads(line)["kind"] for line in open(path)]
    assert kinds.count("expired") == 1
    assert tverify(path, expect_closed=True) == []
    assert jverify(path, expect_closed=True) == []


def test_cancel_and_saturation(model, tmp_path):
    _, _, cfg, tp = model
    path = str(tmp_path / "j.jsonl")
    fleet = _fleet(tp, cfg, 1, path, max_pending=2,
                   engine_kw={"max_slots": 1})
    p = np.arange(1, 9, dtype=np.int32)
    try:
        a = fleet.submit(p, 40)
        b = fleet.submit(p, 6, temperature=0.8, seed=1)
        with pytest.raises(FleetSaturated):
            fleet.submit(p, 5)
        assert a.cancel()
        with pytest.raises(RequestCancelled) as e:
            a.result(timeout=120)
        assert e.value.rid == a.rid
        b.result(timeout=120)
        assert not a.cancel()  # already terminal
        c = fleet.submit(p, 3)
        c.result(timeout=120)
        st = fleet.stats()
        assert st["shed"] == 1 and st["cancelled"] == 1
        assert st["completed"] == 2 and st["lost"] == 0
    finally:
        fleet.close()
    recs = [json.loads(line) for line in open(path)]
    assert sum(r["kind"] == "submit" for r in recs) == 3
    assert [r["rid"] for r in recs if r["kind"] == "cancelled"] == [a.rid]
    assert tverify(path, expect_closed=True) == []
    assert jverify(path, expect_closed=True) == []


def test_drain_refill_and_dead_refill(model, trace, jax_tokens):
    _, _, cfg, tp = model
    fleet = _fleet(tp, cfg, 2)
    try:
        hs = [fleet.submit(**r) for r in trace]
        assert fleet.drain(0, wait=True, timeout=120)
        assert fleet.stats()["replicas"][0]["state"] == "drained"
        assert [list(h.result(timeout=120)[len(r["prompt"]):])
                for h, r in zip(hs, trace)] == jax_tokens
        fleet.refill(0)  # drained: the same incarnation, warm
        st = fleet.stats()["replicas"][0]
        assert st["state"] == "live" and st["incarnation"] == 1
        fleet.kill_replica(1)
        deadline = time.monotonic() + 60
        while fleet.stats()["replicas"][1]["state"] != "dead":
            assert time.monotonic() < deadline
            time.sleep(0.01)
        fleet.refill(1)  # dead: a fresh incarnation
        assert fleet.stats()["replicas"][1]["incarnation"] == 2
        h = fleet.submit(**trace[0])
        assert list(h.result(timeout=120)[len(trace[0]["prompt"]):]) == \
            jax_tokens[0]
        assert fleet.stats()["lost"] == 0
    finally:
        fleet.close()


def test_engine_fleet_knobs(model):
    """scheduler_hook passes the yield point "engine:<replica_id>:step" at
    every step; weights_version tags the engine and its report."""
    _, _, cfg, tp = model

    class Hook(SchedulerHook):
        def __init__(self):
            self.points = []

        def yield_point(self, point):
            self.points.append(point)

    hook = Hook()
    eng = ServingEngine(tp, cfg, device="cpu", replica_id="r7",
                        scheduler_hook=hook, weights_version=3)
    eng.submit(np.arange(1, 6, dtype=np.int32), 3)
    n = 0
    while eng.step():
        n += 1
    assert hook.points == ["engine:r7:step"] * (n + 1)
    assert eng.weights_version == 3
    assert eng.metrics.report()["weights_version"] == 3
    assert ServingEngine(tp, cfg, device="cpu").metrics.report()[
        "weights_version"] is None


def test_operator_accessors(model, trace):
    """busiest_replica() names a replica with started work (killing it
    fails over once), engine_counts() reads the engines only after
    close, and served_weights() gives each replica's version and params."""
    _, _, cfg, tp = model
    fleet = _fleet(tp, cfg, 2)
    try:
        assert fleet.busiest_replica() is None
        assert [(n, v) for n, v, _ in fleet.served_weights()] == \
            [("r0", 0), ("r1", 0)]
        assert all(p is tp for _, _, p in fleet.served_weights())
        long = fleet.submit(np.arange(1, 9, dtype=np.int32), 48)
        hs = [long] + [fleet.submit(**r) for r in trace]
        victim, deadline = None, time.monotonic() + 60
        while victim is None and not long.done:
            assert time.monotonic() < deadline
            victim = fleet.busiest_replica()
            time.sleep(0.001)
        assert victim is not None
        fleet.kill_replica(victim)
        for h in hs:
            h.result(timeout=120)
        st = fleet.stats()
        with pytest.raises(RuntimeError, match="close the fleet first"):
            fleet.engine_counts()
    finally:
        fleet.close()
    assert st["failovers"] == 1 and st["lost"] == 0
    counts = fleet.engine_counts()
    assert len(counts) == 2 and all(c is not None for c in counts)
    assert sum(c["decode_steps"] for c in counts) >= 48
    assert sum(c["prefill_chunks"] for c in counts) >= len(hs)


# --- interchange: journals and weights ---------------------------------

@pytest.fixture(scope="module")
def jax_fleet(model, trace, tmp_path_factory):
    """ONE JAX fleet for the module: it serves the trace with a kill
    (its journal is read by the port), then rolls onto weight sets the
    port wrote."""
    jcfg, jp, _, _ = model
    d = tmp_path_factory.mktemp("jax_fleet")
    path = str(d / "j.jsonl")
    inj = JaxInjector("exc@3")
    fleet = JaxFleet(jp, jcfg, n_replicas=2, journal_path=path,
                     heartbeat_timeout_s=300.0, journal_compact_every=None,
                     ckpt_dir=str(d / "ckpt"),
                     engine_kw=dict(ENGINE, paged_kernel="gather"),
                     engine_kw_for=lambda i: (
                         {"fault_injector": inj} if i == 0 else {}))
    hs = [fleet.submit(**r) for r in trace]
    toks = [list(np.asarray(h.result(timeout=300))[len(r["prompt"]):])
            for h, r in zip(hs, trace)]
    fleet.refill(0)
    yield dict(fleet=fleet, journal=path, ckpt=str(d / "ckpt"),
               tokens=toks, stats=fleet.stats())
    fleet.close()


def _cut_before_done(src, dst):
    with open(src) as f, open(dst, "w") as g:
        for line in f:
            if json.loads(line)["kind"] != "done":
                g.write(line)
    return dst


def test_journals_read_both_ways(model, trace, jax_tokens, jax_fleet,
                                 tmp_path):
    _, _, cfg, tp = model
    assert jax_fleet["tokens"] == jax_tokens
    assert jax_fleet["stats"]["failovers"] == 1
    tpath = str(tmp_path / "port.jsonl")
    inj = FaultInjector("exc@3")
    fleet = _fleet(tp, cfg, 2, tpath, engine_kw_for=lambda i: (
        {"fault_injector": inj} if i == 0 else {}))
    try:
        _serve(fleet, trace)
    finally:
        fleet.close()
    jpath = jax_fleet["journal"]
    # the JAX fleet is still open: its journal holds what it flushed
    for path in (tpath, jpath):
        for verify in (tverify, jverify):
            assert verify(path) == []
        for Journal in (RequestJournal, jfleet_mod.RequestJournal):
            assert Journal.recover(path) == []
        cut = _cut_before_done(path, str(tmp_path / "cut.jsonl"))
        t_open = RequestJournal.recover(cut)
        j_open = jfleet_mod.RequestJournal.recover(cut)
        assert t_open == j_open
        assert sorted(rid for rid, _ in t_open) == list(range(len(trace)))
        assert RequestJournal.recover_progress(cut) == \
            jfleet_mod.RequestJournal.recover_progress(cut)
        t_diag = [(d.code, d.detail) for d in tverify(cut,
                                                      expect_closed=True)]
        j_diag = [(d.code, d.detail) for d in jverify(cut,
                                                      expect_closed=True)]
        assert t_diag == j_diag and {c for c, _ in t_diag} == {"J007"}
    # a port journal reopened by the JAX journal continues past its rids
    j = jfleet_mod.RequestJournal(tpath)
    assert j.next_rid() == len(trace)
    j.close()


def _perturbed(tp, seed):
    """A second weight set: `tp` plus 0.05 N(0, 1), seeded."""
    g = torch.Generator().manual_seed(seed)
    return _tmap(lambda t: t + 0.05 * torch.randn(t.shape, generator=g),
                 tp)


def _tmap(fn, x):
    if isinstance(x, dict):
        return {k: _tmap(fn, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tmap(fn, v) for v in x]
    return fn(x)


def _to_jax(tp):
    return _tmap(lambda t: jnp.asarray(t.numpy()), tp)


def test_port_weights_roll_onto_the_jax_fleet(model, trace, jax_fleet):
    jcfg, _, _, tp = model
    tp2 = _perturbed(tp, 5)
    save_weights(tp2, jax_fleet["ckpt"], 7)
    fleet = jax_fleet["fleet"]
    out = fleet.roll_weights(7)
    assert out["version"] == 7 and out["replicas_swapped"] == 2
    jp2 = _to_jax(tp2)
    want = tp_.tokens_of(JaxEngine(jp2, jcfg, paged_kernel="gather",
                                   **ENGINE), trace[:3])
    hs = [fleet.submit(**r) for r in trace[:3]]
    got = [list(np.asarray(h.result(timeout=300))[len(r["prompt"]):])
           for h, r in zip(hs, trace)]
    assert got == want
    assert all(h.weights_version == 7 for h in hs)


def test_jax_weights_roll_onto_the_port_fleet(model, trace, tmp_path):
    jcfg, jp, cfg, tp = model
    tp2 = _perturbed(tp, 6)
    jp2 = _to_jax(tp2)
    ckpt = str(tmp_path / "ckpt")
    jfleet_mod.save_weights(jp2, ckpt, 3)
    fleet = _fleet(tp, cfg, 2, ckpt_dir=ckpt)
    try:
        out = fleet.roll_weights(3)
        assert out["version"] == 3 and out["replicas_swapped"] == 2
        for a, b in zip(T._leaves(fleet._params), T._leaves(tp2)):
            assert a.dtype == b.dtype and torch.equal(a, b)
        want = tp_.tokens_of(JaxEngine(jp2, jcfg, paged_kernel="gather",
                                       **ENGINE), trace[:3])
        hs = _serve(fleet, trace[:3])
        assert [list(h.tokens) for h in hs] == want
        assert all(h.weights_version == 3 for h in hs)
    finally:
        fleet.close()


def _bf16_pair(model):
    _, _, cfg, tp = model
    bcfg = T.TransformerConfig(vocab=cfg.vocab, dim=cfg.dim,
                               heads=cfg.heads, layers=cfg.layers,
                               max_len=cfg.max_len, dtype=torch.bfloat16)
    tb = _tmap(lambda t: t.to(torch.bfloat16), tp)
    tb2 = _tmap(lambda t: t.to(torch.bfloat16), _perturbed(tp, 8))
    return bcfg, tb, tb2


def test_a_jax_bf16_weight_set_stays_bf16_in_the_port(model, tmp_path):
    """The JAX package writes bfloat16 leaves as 2-byte raw records; the
    port reads their bits back as bfloat16 and serves them bf16."""
    bcfg, tb, tb2 = _bf16_pair(model)
    jb2 = _tmap(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16),
                tb2)
    ckpt = str(tmp_path / "ckpt")
    jfleet_mod.save_weights(jb2, ckpt, 2)
    fleet = _fleet(tb, bcfg, 1, ckpt_dir=ckpt)
    try:
        fleet.roll_weights(2)
        for rep in fleet._replicas:
            got = T._leaves(rep.params if rep.params is not None
                            else fleet._params)
            for a, b in zip(got, T._leaves(tb2)):
                assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        h = fleet.submit(np.arange(1, 9, dtype=np.int32), 4)
        assert len(h.result(timeout=120)) == 12
    finally:
        fleet.close()


def test_a_port_bf16_weight_set_rolls_onto_the_jax_fleet(model, tmp_path):
    """The port writes bfloat16 leaves as float32 (exact): the JAX
    fleet's rollout loads the same values, and the port reads its own
    file back bf16, bit for bit."""
    bcfg, tb, tb2 = _bf16_pair(model)
    ckpt = str(tmp_path / "ckpt")
    save_weights(tb2, ckpt, 4)
    jb = _tmap(lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16), tb)
    jcfg = tp_.J.TransformerConfig(dtype=jnp.bfloat16, **dict(
        tp_.DIMS, **DIMS))
    fleet = JaxFleet(jb, jcfg, n_replicas=1, ckpt_dir=ckpt,
                     heartbeat_timeout_s=300.0,
                     engine_factory=ScriptEngine)
    try:
        fleet.roll_weights(4)
        got = jax.tree_util.tree_leaves(fleet._params)
        want = T._leaves(tb2)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          b.float().numpy())
    finally:
        fleet.close()
    back = load_weights(tb, ckpt, 4)
    for a, b in zip(T._leaves(back), T._leaves(tb2)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_a_foreign_checkpoint_is_refused_alike(model, tmp_path):
    """A raw training checkpoint (other entry names), a weight set of
    another model (another leaf count) and one of another width are each
    refused as RolloutAborted, with the JAX package's message, and the
    fleet keeps serving its version."""
    from paddle_tpu_torch.distributed.checkpoint import save_checkpoint

    jcfg, jp, cfg, tp = model
    ckpt = str(tmp_path / "ckpt")
    scope = tfleet_mod._FlatScope({"fc_0.w_0": np.zeros((4, 3),
                                                       np.float32)})
    save_checkpoint(scope, ckpt, step=1)
    small = T.init_params(T.TransformerConfig(vocab=64, dim=32, heads=4,
                                              layers=1, max_len=64),
                          torch.Generator(), device="cpu")
    save_weights(small, ckpt, 2, keep_last=8)
    wide = T.init_params(T.TransformerConfig(vocab=64, dim=48, heads=4,
                                             layers=2, max_len=64),
                         torch.Generator(), device="cpu")
    save_weights(wide, ckpt, 3, keep_last=8)
    fleet = _fleet(tp, cfg, 1, ckpt_dir=ckpt)
    jfl = JaxFleet(jp, jcfg, n_replicas=1, ckpt_dir=ckpt,
                   heartbeat_timeout_s=300.0, engine_factory=ScriptEngine)
    try:
        for step, why in ((1, "was not written by save_weights"),
                          (2, "weight leaf(s), the serving model has"),
                          (3, "the serving model expects")):
            with pytest.raises(RolloutAborted) as te:
                fleet.roll_weights(step)
            with pytest.raises(jfleet_mod.RolloutAborted) as je:
                jfl.roll_weights(step)
            assert str(te.value) == str(je.value)
            assert why in str(te.value)
        st = fleet.stats()
        assert st["rollout_aborts"] == 3 and st["weights_version"] == 0
        assert st["replicas"][0]["state"] == "live"
    finally:
        fleet.close()
        jfl.close()


# --- the subprocess drill ------------------------------------------------

def test_subprocess_kill_drill_no_request_lost(model, trace, jax_tokens,
                                               tmp_path):
    """Two worker processes of the port serve the trace's greedy
    requests as coordinator leases; w0 is SIGKILLed mid-decode
    (PADDLE_FAULT=kill@5), restarted by the supervisor, its lease times
    out and requeues, and every request completes exactly once with the
    JAX engine's tokens."""
    from paddle_tpu_torch.serving import run_fleet_subprocess

    _, _, cfg, tp = model
    ckpt = str(tmp_path / "weights")
    save_weights(tp, ckpt, 1)
    mspec = {"vocab": cfg.vocab, "dim": cfg.dim, "heads": cfg.heads,
             "layers": cfg.layers, "max_len": cfg.max_len, "max_slots": 2}
    greedy = [i for i, r in enumerate(trace) if r["temperature"] == 0.0]
    specs = [{"prompt": [int(t) for t in trace[i]["prompt"]],
              "max_new_tokens": trace[i]["max_new_tokens"],
              "temperature": 0.0, "eos_id": None, "seed": 0}
             for i in greedy]
    out_dir = tmp_path / "results"
    out_dir.mkdir()

    def env_for(wid):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env["FLEET_MODEL"] = json.dumps(mspec)
        env["FLEET_WEIGHTS"] = json.dumps({"dir": ckpt, "step": 1})
        # must exceed the lease timeout: a survivor may exit only once
        # a dead peer's lease had time to requeue
        env["FLEET_IDLE_GRACE_S"] = "2.5"
        if wid == "w0":
            env["PADDLE_FAULT"] = "kill@5"
        return env

    res = run_fleet_subprocess(
        lambda wid, addr: [sys.executable,
                           os.path.join(HERE, "torch_fleet_worker.py"),
                           str(out_dir), addr],
        ["w0", "w1"], specs, lease_timeout_s=1.5, env_for=env_for,
        deadline_s=120.0)
    rep = res["report"]
    assert rep["ok"], rep
    assert rep["workers"]["w0"]["restarts"] == 1
    assert rep["workers"]["w0"]["exit_codes"][0] == -signal.SIGKILL
    assert res["coordinator"]["done"] == len(specs)
    assert res["coordinator"]["discarded"] == 0
    for k, i in enumerate(greedy):
        rec = json.load(open(out_dir / ("%d.json" % k)))
        assert rec["tokens"] == jax_tokens[i]


# --- a fault of the reference, repaired in the port -----------------------

def _drain_with_a_queued_canary(fleet_cls, script_engine, path):
    """Two replicas whose engines block inside step() until released, a
    canary queued in replica 0's inbox, then drain(0): the drain re-routes
    what replica 0 had queued. Returns the journal's records."""
    import threading

    from paddle_tpu_torch.analysis.sched_explore import script_tokens
    from paddle_tpu_torch.serving import CANARY_PROMPT

    gate = threading.Event()

    class Blocking(script_engine):
        def step(self):
            gate.wait(30)
            return super().step()

    cfg = type("Cfg", (), {"max_len": 64})()
    params = {"pos": np.zeros((64, 4), np.float32)}
    fleet = fleet_cls(params, cfg, n_replicas=2, journal_path=path,
                      heartbeat_timeout_s=3600.0, monitor_interval_s=0.01,
                      affinity=False, engine_factory=Blocking,
                      canary_interval_s=0.05,
                      canary_golden=script_tokens(CANARY_PROMPT, 0, 4),
                      journal_compact_every=None)
    try:
        hs = [fleet.submit(np.arange(1, 6, dtype=np.int32), 6, seed=k)
              for k in range(2)]
        deadline = time.monotonic() + 30
        while True:
            with fleet._cond:
                ch = fleet._canaries[0]
                if ch is not None and ch in fleet._inbox[0]:
                    break
            assert time.monotonic() < deadline
            time.sleep(0.005)
        fleet.drain(0)
        gate.set()
        for h in hs:
            h.result(timeout=30)
    finally:
        gate.set()
        fleet.close()
    return [json.loads(line) for line in open(path)]


def test_a_draining_replicas_canary_never_reaches_the_journal(tmp_path):
    """The reference re-routes a draining replica's queued canary like a
    request, journaling an assign for a rid that was never submitted
    (J001, and J007 at close); the port releases the canary instead."""
    from paddle_tpu_torch.analysis.sched_explore import \
        ScriptEngine as TScript

    p = str(tmp_path / "port.jsonl")
    recs = _drain_with_a_queued_canary(ServingFleet, TScript, p)
    assert all(r["rid"] >= 0 for r in recs)
    assert tverify(p, expect_closed=True) == []
    assert jverify(p, expect_closed=True) == []
    j = str(tmp_path / "jax.jsonl")
    recs = _drain_with_a_queued_canary(JaxFleet, ScriptEngine, j)
    assert any(r["rid"] < 0 for r in recs if r["kind"] == "assign")
    assert "J001" in {d.code for d in jverify(j, expect_closed=True)}
