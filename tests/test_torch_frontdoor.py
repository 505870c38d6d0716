"""The port's wire front door (paddle_tpu_torch.serving.wire / frontdoor /
loadgen) against the JAX package's, over real sockets on the CPU.

Frames are interchangeable: a JAX `WireClient` talking to the port's
`FrontDoor` and a port `WireClient` talking to the JAX package's get
the same welcome, accepted and done frames as each package's own pair,
the same typed error frames for the same faults, and streamed chunks
that concatenate to the done frame. Both fleets serve the same weights,
so every answer also equals the JAX engine's tokens. A dropped
connection cancels its request (journaled `cancelled`), the open-loop
load generator of either package drives the other's door with every
request resolved, and `find_knee` gives the same result on the same
reports. Exact."""

import json
import socket
import time

import numpy as np
import pytest
import torch

import torch_parity as tp_
from paddle_tpu.serving import FrontDoor as JDoor
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import ServingFleet as JFleet
from paddle_tpu.serving import TenantRegistry as JTenants
from paddle_tpu.serving import loadgen as jload
from paddle_tpu.serving import wire as jwire
from paddle_tpu.analysis.protocol_lint import verify_journal as jverify
from paddle_tpu_torch.analysis.protocol_lint import verify_journal as tverify
from paddle_tpu_torch.serving import FrontDoor as TDoor
from paddle_tpu_torch.serving import ServingFleet as TFleet
from paddle_tpu_torch.serving import TenantRegistry as TTenants
from paddle_tpu_torch.serving import loadgen as tload
from paddle_tpu_torch.serving import wire as twire

torch.set_num_threads(2)

ENGINE = dict(max_slots=4, kv_block_tokens=8, prefill_chunk_tokens=16,
              prefix_cache_tokens=128)
AUTH = {"tok-alice": "alice", "tok-bob": "bob"}
WIRES = {"jax": jwire, "torch": twire}
PROMPT = [5, 9, 2, 33, 7, 1, 60, 12, 8]


def _tenants(mod):
    reg = mod()
    reg.add("alice", rate=1e6, burst=1e6, weight=2.0)
    reg.add("bob", rate=1e6, burst=1e6, weight=1.0)
    return reg


@pytest.fixture(scope="module")
def doors(tmp_path_factory):
    """One front door of each package over a two-replica fleet of the
    same weights (the JAX init), two tenants each."""
    jcfg, jp, tcfg, tp = tp_.models(0, vocab=64, max_len=256)
    d = tmp_path_factory.mktemp("doors")
    jfl = JFleet(jp, jcfg, n_replicas=2, journal_path=str(d / "jax.jsonl"),
                 heartbeat_timeout_s=300.0, tenants=_tenants(JTenants),
                 engine_kw=dict(ENGINE, paged_kernel="gather"))
    tfl = TFleet(tp, tcfg, n_replicas=2,
                 journal_path=str(d / "torch.jsonl"),
                 heartbeat_timeout_s=300.0, tenants=_tenants(TTenants),
                 engine_kw=dict(ENGINE, device="cpu"))
    jd = JDoor(jfl, auth=AUTH).start()
    td = TDoor(tfl, auth=AUTH).start()
    eng = JaxEngine(jp, jcfg, paged_kernel="gather", **ENGINE)
    want = {}
    for seed, n in ((3, 6), (4, 12)):
        h = eng.submit(np.asarray(PROMPT, np.int32), n, seed=seed,
                       temperature=0.8 if seed == 4 else 0.0)
        eng.run()
        want[seed] = [int(t) for t in h.tokens]
    # warm both fleets (the JAX engines compile on their first steps)
    for fl in (jfl, tfl):
        fl.submit(np.asarray(PROMPT, np.int32), 2,
                  tenant="alice").result(timeout=300)
    yield {"jax": (jfl, jd), "torch": (tfl, td), "want": want,
           "journals": {"jax": str(d / "jax.jsonl"),
                        "torch": str(d / "torch.jsonl")}}
    for fl, door in ((jfl, jd), (tfl, td)):
        door.close()
        fl.close()


def _frames(wire, address, token, gen):
    """Open a client of `wire`, say hello, send one generate and read
    every frame of it up to its done or error."""
    c = wire.WireClient(address)
    c.send({"op": "hello", "token": token})
    frames = [c.recv()]
    c.send(dict(gen, op="generate"))
    while True:
        f = c.recv()
        frames.append(f)
        if f is None or f.get("op") in ("done", "error"):
            break
    c.close()
    return frames


def _shape(frames):
    """What must be the same on every pairing: the welcome frame, the
    accepted frame's keys, the done frame without the replica that
    answered, and the concatenated chunks."""
    welcome, rest = frames[0], frames[1:]
    ops = [f["op"] for f in rest]
    chunks = [t for f in rest if f["op"] == "tokens" for t in f["tokens"]]
    done = dict(rest[-1])
    done.pop("replica", None)
    return welcome, ops[0], sorted(rest[0]), done, chunks


@pytest.mark.parametrize("client", ["jax", "torch"])
@pytest.mark.parametrize("door", ["jax", "torch"])
@pytest.mark.parametrize("stream", [True, False])
def test_clients_and_doors_interoperate(doors, client, door, stream):
    _fl, fd = doors[door]
    seed = 4 if stream else 3
    n = len(doors["want"][seed])
    gen = {"id": "q-%s-%s-%d" % (client, door, stream), "prompt": PROMPT,
           "max_new_tokens": n, "seed": seed, "stream": stream,
           "temperature": 0.8 if seed == 4 else 0.0}
    frames = _frames(WIRES[client], fd.address, "tok-alice", gen)
    welcome, first, accepted_keys, done, chunks = _shape(frames)
    assert welcome == {"op": "welcome", "proto": 1, "tenant": "alice"}
    assert first == "accepted" and accepted_keys == ["id", "op", "rid"]
    assert done["op"] == "done" and done["id"] == gen["id"]
    assert done["tokens"] == doors["want"][seed] and done["n"] == n
    assert chunks == (done["tokens"] if stream else [])
    # the client's own blocking call agrees
    c = WIRES[client].WireClient(fd.address, token="tok-bob")
    got = c.generate_blocking(gen["id"] + "b", PROMPT, n, seed=seed,
                              stream=stream,
                              temperature=gen["temperature"])
    c.close()
    assert got["tokens"] == doors["want"][seed]
    assert [t for ch in got["chunks"] for t in ch] == \
        (got["tokens"] if stream else [])


RAW_FAULTS = {
    "bad_token": [{"op": "hello", "token": "nope"}],
    "no_hello": [{"op": "generate", "id": "x", "prompt": [1],
                  "max_new_tokens": 2}],
    "unknown_op": [{"op": "hello", "token": "tok-bob"},
                   {"op": "warp", "id": "x"}],
    "unknown_key": [{"op": "hello", "token": "tok-bob"},
                    {"op": "generate", "id": "x", "prompt": [1],
                     "max_new_tokens": 2, "warp_factor": 9}],
    "no_id": [{"op": "hello", "token": "tok-bob"},
              {"op": "generate", "prompt": [1], "max_new_tokens": 2}],
    "bad_prompt": [{"op": "hello", "token": "tok-bob"},
                   {"op": "generate", "id": "x", "prompt": "abc",
                    "max_new_tokens": 2}],
    "not_json": [b"this is not json\n"],
    "ping": [{"op": "ping"}],
}


def _raw(address, sends):
    s = socket.create_connection(address, timeout=30)
    rf = s.makefile("rb")
    out = []
    for m in sends:
        s.sendall(m if isinstance(m, bytes) else
                  (json.dumps(m) + "\n").encode())
        line = rf.readline()
        out.append(json.loads(line) if line else None)
    s.close()
    return out


@pytest.mark.parametrize("fault", sorted(RAW_FAULTS))
def test_the_same_typed_errors(doors, fault):
    got = {side: _raw(doors[side][1].address, RAW_FAULTS[fault])
           for side in ("jax", "torch")}
    assert got["torch"] == got["jax"]
    last = got["torch"][-1]
    assert last is not None
    if fault != "ping":
        assert last["op"] == "error" and last["code"] in \
            twire.ERROR_CODES


def test_wire_vocabulary_is_the_same():
    assert twire.ERROR_CODES == jwire.ERROR_CODES
    assert twire.MAX_FRAME_BYTES == jwire.MAX_FRAME_BYTES
    assert twire.PROTO_VERSION == jwire.PROTO_VERSION
    import paddle_tpu.serving as J
    import paddle_tpu_torch.serving as T

    cases = [("FleetSaturated", ("full",), {}, "FLEET_SATURATED"),
             ("TenantQuotaExceeded", ("spent",), {"retry_after_s": 0.5},
              "TENANT_QUOTA_EXCEEDED"),
             ("DeadlineExceeded", ("late",), {}, "DEADLINE_EXCEEDED"),
             ("RequestCancelled", ("gone",), {}, "CANCELLED"),
             ("FleetTimeout", ("slow",), {}, "TIMEOUT"),
             ("EngineFailed", ("dead\nmore",), {}, "ENGINE_FAILED")]
    for name, args, kw, code in cases:
        exc = getattr(T, name)(*args, **kw)
        assert twire.error_code_for(exc)[0] == code
        assert twire.error_frame(exc, "i") == jwire.error_frame(
            getattr(J, name)(*args, **kw), "i")
    for exc, code in ((ValueError("x"), "BAD_REQUEST"),
                      (RuntimeError("y"), "INTERNAL")):
        assert twire.error_frame(exc, None) == jwire.error_frame(exc, None)
        assert twire.error_code_for(exc)[0] == code
    assert twire.encode_frame({"op": "pong"}) == \
        jwire.encode_frame({"op": "pong"})


@pytest.mark.parametrize("client", ["jax", "torch"])
def test_disconnect_cancels_on_the_port_door(doors, client):
    fl, fd = doors["torch"]
    before = fl.stats()["cancelled"]
    c = WIRES[client].WireClient(fd.address, token="tok-bob")
    c.generate("drop-" + client, PROMPT, 240, seed=11, stream=True)
    f = c.recv()
    while f is not None and f.get("op") not in ("tokens", "done"):
        f = c.recv()
    assert f is not None and f["op"] == "tokens"
    c.close()
    t0 = time.monotonic()
    # the front door counts its disconnect cancel just after the fleet
    # counts the cancel: wait for both
    while fl.stats()["cancelled"] <= before \
            or fd.stats()["disconnect_cancels"] < 1:
        assert time.monotonic() - t0 < 60
        time.sleep(0.01)
    kinds = [json.loads(line)["kind"]
             for line in open(doors["journals"]["torch"])]
    assert "cancelled" in kinds
    assert fl.stats()["lost"] == 0


@pytest.mark.parametrize("gen_side,door", [("jax", "torch"),
                                           ("torch", "jax")])
def test_open_loop_drives_the_other_door(doors, gen_side, door):
    load = {"jax": jload, "torch": tload}[gen_side]
    tenants = [{"name": "alice", "token": "tok-alice", "weight": 2.0},
               {"name": "bob", "token": "tok-bob", "weight": 1.0}]
    rep = load.run_open_loop(doors[door][1].address, tenants, 8.0, 0.6,
                             seed=3, prompt_len=6, max_new_tokens=5,
                             vocab=64, stream=True, settle_s=120.0)
    assert rep["stream_divergent"] == 0 and rep["duplicate_rids"] == 0
    assert rep["wire_unresolved"] == 0
    assert rep["completed"] == rep["sent"] > 0
    assert set(rep["per_tenant"]) <= {"alice", "bob"}


def test_journals_stay_clean(doors):
    for side in ("jax", "torch"):
        path = doors["journals"][side]
        assert tverify(path) == [] and jverify(path) == []


def _report(rate, goodput, p99, shed):
    return {"rate_rps": rate, "offered_rps": rate, "goodput_rps": goodput,
            "ttft_p99_s": p99, "shed": shed}


@pytest.mark.parametrize("seed", range(6))
def test_find_knee_same_result(seed):
    rng = np.random.RandomState(seed)
    sweeps = [[], [_report(10, 10.0, 0.01, {})],
              [_report(10, 10.0, 0.01, {}), _report(20, 19.5, 0.012, {}),
               _report(40, 22.0, 0.25, {"FLEET_SATURATED": 11}),
               _report(80, 21.0, 0.9, {"FLEET_SATURATED": 50})]]
    for _ in range(20):
        rates = np.cumsum(rng.uniform(1, 20, int(rng.randint(1, 6))))
        sweeps.append([_report(float(r), float(r * rng.uniform(0.5, 1.05)),
                               float(rng.uniform(0.005, 2.0)),
                               {"FLEET_SATURATED": int(rng.randint(0, 5))}
                               if rng.rand() < 0.4 else {})
                       for r in rates])
    for sw in sweeps:
        assert tload.find_knee(sw) == jload.find_knee(sw)
    assert tload.find_knee(sweeps[2])["knee_rate_rps"] == 40
