"""The port's serving engine (paddle_tpu_torch/serving/engine.py) against
the JAX engine on one fixed trace.

Both engines get the same weights (the JAX init through
`params_from_numpy`) and the same requests: a shared 16-token header,
chunked prefill, the prefix cache (aliased hits and one copy-on-write
resubmit), a block pool small enough to force backpressure, greedy and
sampled requests and an EOS. The JAX engine runs the gather form on the
CPU; the port runs its default fused wrapper, which on CPU tensors is
the paged kernel's plain version. The bar: identical tokens and finish
reasons per request, identical scheduler trajectories (queue depth,
live and prefilling slots, blocks in use after every step), and the
same prefix hits and copy-on-writes.
"""

import time

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.models import transformer as J
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import ServingEngine

torch.set_num_threads(2)

DIMS = dict(vocab=50, dim=32, heads=4, layers=2, max_len=64)
ENGINE = dict(max_slots=3, kv_block_tokens=8, prefill_chunk_tokens=8,
              prefix_cache_tokens=64, kv_pool_blocks=13,
              max_prefills_per_step=2)


def _models(seed):
    jcfg = J.TransformerConfig(**DIMS)
    jp = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, T.TransformerConfig(**DIMS), tp


def _trace(seed, cfg, tp):
    rng = np.random.RandomState(seed)
    header = rng.randint(0, DIMS["vocab"], 16).astype(np.int32)
    reqs = []
    for i, (tail, n) in enumerate([(3, 6), (9, 8), (5, 7), (12, 5),
                                   (1, 8), (6, 6)]):
        prompt = np.concatenate(
            [header, rng.randint(0, DIMS["vocab"], tail).astype(np.int32)])
        reqs.append(dict(prompt=prompt, max_new_tokens=n,
                         temperature=0.8 if i % 2 else 0.0, seed=100 + i,
                         publish_len=len(header), eos_id=None))
    # a deterministic EOS: request 4's third greedy token (the port's
    # generate() equals the reference's, test_torch_transformer.py)
    greedy = T.generate(tp, torch.from_numpy(reqs[4]["prompt"][None]).long(),
                        cfg, 3)
    reqs[4]["eos_id"] = int(greedy[0, -1])
    return reqs


def _drive(eng, reqs, cow_prompt):
    handles = [eng.submit(**r) for r in reqs]
    traj = []
    while eng.step():
        traj.append((eng.queue_depth, eng.live_slots, eng.prefilling_slots,
                     eng.kv_blocks_in_use))
    # whole-block prompt: published in full, its resubmit is the
    # maximal-reuse case whose last block is copied on write
    for _ in range(2):
        handles.append(eng.submit(cow_prompt, 4))
        eng.run()
    out = [(list(h.full_prompt) + h.tokens, h.finish_reason)
           for h in handles]
    return out, traj


def test_engine_trace_matches_jax_engine_token_for_token():
    jcfg, jp, cfg, tp = _models(0)
    reqs = _trace(0, cfg, tp)
    cow_prompt = np.random.RandomState(1).randint(0, 50, 24).astype(np.int32)
    jeng = JaxEngine(jp, jcfg, paged_kernel="gather", **ENGINE)
    teng = ServingEngine(tp, cfg, device="cpu", **ENGINE)
    assert teng.paged_kernel == "fused"
    jout, jtraj = _drive(jeng, reqs, cow_prompt)
    tout, ttraj = _drive(teng, reqs, cow_prompt)
    assert tout == jout
    assert ttraj == jtraj
    # the trace really exercised backpressure (queued requests beside a
    # free slot: blocks, not slots, are the wall) and reuse
    assert any(q and live + pre < ENGINE["max_slots"]
               for q, live, pre, _ in ttraj)
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    assert trep["prefix_cache"]["hits"] == jrep["prefix_cache"]["hits"] >= 2
    assert trep["cow_blocks"] == jrep["cow_blocks"] >= 1
    assert teng.kv_blocks_in_use == jeng.kv_blocks_in_use
    assert trep["kv_blocks_in_use"] == jrep["kv_blocks_in_use"]
    assert trep["prefill_tokens_computed"] == jrep["prefill_tokens_computed"]
    assert {r for _, r in tout} == {"budget", "eos"}
    # greedy requests equal the port's own sequential generate()
    for r, (seq, _) in zip(reqs, tout):
        if r["temperature"] == 0 and r["eos_id"] is None:
            want = T.generate(tp, torch.from_numpy(r["prompt"][None]).long(),
                              cfg, r["max_new_tokens"])
            assert seq == want[0].tolist()


def test_cancel_and_deadline_verdicts():
    _, _, cfg, tp = _models(1)
    eng = ServingEngine(tp, cfg, max_slots=1, kv_block_tokens=8,
                        device="cpu")
    a = eng.submit(np.arange(5), 6)
    b = eng.submit(np.arange(7), 6)
    c = eng.submit(np.arange(3), 6, deadline_at=time.monotonic() - 1.0)
    assert eng.cancel(b.rid)
    eng.run()
    assert (a.finish_reason, b.finish_reason, c.finish_reason) == \
        ("budget", "cancelled", "expired")
    assert len(a.tokens) == 6 and b.tokens == [] and c.tokens == []
    assert eng.metrics.cancelled == 1 and eng.metrics.expired == 1
    assert eng.kv_blocks_in_use == 0


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_resume_continues_the_key_schedule(temperature):
    """A request resumed with the tokens an earlier incarnation emitted
    decodes exactly the rest of the uninterrupted run: the resumed
    tokens become prefill context and sampling continues at index
    resume_len of the fold_in schedule."""
    _, _, cfg, tp = _models(4)
    prompt = np.random.RandomState(4).randint(0, 50, 11).astype(np.int32)
    whole = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=8,
                          device="cpu")
    h = whole.submit(prompt, 9, temperature=temperature, seed=5)
    whole.run()
    eng = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=8,
                        device="cpu")
    r = eng.submit(prompt, 9, temperature=temperature, seed=5,
                   resume_tokens=h.tokens[:4])
    eng.run()
    assert r.tokens == h.tokens[4:]
    assert list(r.result()) == list(prompt) + h.tokens
    assert eng.metrics.resume_tokens_reused == 4


def test_spike_sentinel_trips_on_a_sustained_excursion():
    from paddle_tpu_torch.serving import ServingSentinel

    sent = ServingSentinel(spike_factor=4.0, hysteresis=2, warmup=3)
    assert [sent.observe(False, 10.0) for _ in range(5)] == ["ok"] * 5
    assert sent.observe(False, 100.0) == "ok"  # one spike: held
    assert sent.observe(False, 100.0) == "spike"  # sustained: trips
    assert sent.observe(True, 10.0) == "trap"
    assert sent.trips == 2
    _, _, cfg, tp = _models(5)
    with pytest.raises(ValueError, match="integrity_traps"):
        ServingEngine(tp, cfg, integrity_traps=False,
                      integrity_spike_factor=4.0, device="cpu")
    eng = ServingEngine(tp, cfg, integrity_spike_factor=50.0, device="cpu")
    h = eng.submit(np.arange(6), 5)
    eng.run()
    assert h.finish_reason == "budget"


@pytest.mark.parametrize("knob,match", [
    pytest.param({"decode_window": 0}, "decode_window", id="knob0"),
    pytest.param({"async_dispatch": True, "spec_draft_len": 4},
                 "spec_draft_len composes", id="knob1"),
    pytest.param({"adapter_registry": "empty"}, "adapter rank unknown",
                 id="knob2"),
    pytest.param({"kv_store": "store"}, "prefix_cache_tokens", id="knob3"),
    pytest.param({"kv_fingerprints": True}, "prefix_cache_tokens",
                 id="knob4"),
])
def test_out_of_scope_knobs_raise(knob, match):
    """The engine knobs an earlier slice refused are all ported now; what
    is left of their refusals are the reference's own ValueErrors: a
    window below 1, spec decoding with a window or async dispatch, an
    adapter pool of unknown rank, and a KV store or fingerprints without
    the prefix cache they hook into."""
    from paddle_tpu_torch.serving import AdapterRegistry, KVBlockStore

    _, _, cfg, tp = _models(2)
    objs = {"empty": AdapterRegistry(), "store": KVBlockStore()}
    knob = {k: objs.get(v, v) if isinstance(v, str) else v
            for k, v in knob.items()}
    with pytest.raises(ValueError, match=match):
        ServingEngine(tp, cfg, device="cpu", **knob)


def test_device_contract():
    _, _, cfg, tp = _models(3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServingEngine(tp, cfg)
    with pytest.raises(ValueError, match="params live on"):
        ServingEngine(tp, cfg, device="meta")
