"""LoRA adapters in the port (paddle_tpu_torch/serving/adapters.py,
models/transformer.py `_adapter_qv`, the engine's `aidx` band) against
the JAX package on the same weights and the same seeded adapters.

* `make_adapter` is bit-identical across the packages from one seed;
  `AdapterPool` keeps the reference's refcounts, LRU eviction of idle
  adapters only and pinned-pool backpressure; ragged ranks are refused.
* `_adapter_qv` and the three paged primitives with an adapter pool
  match the JAX package's (gather form) at atol/rtol 1e-5 in f32.
* Engines: a zero-adapter request is token-identical to an engine with
  no registry; N tenants batched in one engine emit what each tenant's
  sequential engine emits, and what the JAX engine emits; adapter
  requests never alias or publish the prefix trie; unknown or
  pool-less adapters are refused at submit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu.serving import AdapterPool as JaxPool
from paddle_tpu.serving import AdapterRegistry as JaxRegistry
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import make_adapter as jax_make_adapter
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import (AdapterPool, AdapterRegistry,
                                      ServingEngine, make_adapter)
from torch_parity import models

torch.set_num_threads(2)

SMALL = dict(vocab=128, dim=64, heads=4, layers=2, max_len=128)
_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def mdl():
    return models(0, **SMALL)


def _regs(cfg, names=("ad_a", "ad_b"), rank=4):
    """The same adapters registered in both packages' registries."""
    treg, jreg = AdapterRegistry(), JaxRegistry()
    for i, n in enumerate(names):
        ad = make_adapter(cfg, rank=rank, seed=i + 1)
        treg.register(n, ad)
        jreg.register(n, ad)
    return treg, jreg


def test_make_adapter_bit_identical_to_the_reference(mdl):
    jcfg, _, cfg, _ = mdl
    ours = make_adapter(cfg, rank=4, seed=3, scale=0.5)
    ref = jax_make_adapter(jcfg, rank=4, seed=3, scale=0.5)
    assert ours.keys() == ref.keys()
    for k in ("a_q", "b_q", "a_v", "b_v"):
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k])
    assert ours["scale"] == ref["scale"]


def test_adapter_pool_refcounts_lru_eviction_and_backpressure(mdl):
    _, _, cfg, _ = mdl
    reg, _ = _regs(cfg, names=("a", "b", "c"))
    pool = AdapterPool(cfg, reg, slots=3, device="cpu")
    sa = pool.acquire("a")
    sb = pool.acquire("b")
    assert sa != 0 and sb != 0 and sa != sb
    assert pool.refcount("a") == 2  # residency + the request's pin
    assert pool.acquire("c") is None  # both pinned: back off
    pool.release(sa)
    assert pool.refcount("a") == 1
    sc = pool.acquire("c")  # LRU-evicts idle a, never pinned b
    assert sc == sa
    assert pool.resident() == ["b", "c"]
    assert pool.evictions == 1 and pool.misses == 3
    # an upload writes the slot in place, the pool tensors keep theirs
    arr = pool.device_arrays()["a_q"]
    np.testing.assert_array_equal(arr[sc].numpy(), reg.get("c")["a_q"])
    pool.release(sb)
    pool.release(sc)
    pool.acquire("a")
    assert pool.device_arrays()["a_q"] is arr
    assert pool.misses == 4 and pool.uploads == 4
    assert pool.resident() == ["a", "c"]
    assert pool.acquire(None) == 0  # the zero adapter always succeeds
    assert pool.detach("a") is False  # pinned
    assert pool.detach("c") is True   # idle
    assert "c" not in pool.resident()
    assert pool.stats()["slots"] == 3
    with pytest.raises(ValueError, match="adapter_slots"):
        AdapterPool(cfg, reg, slots=1, device="cpu")
    with pytest.raises(ValueError, match="rank unknown"):
        AdapterPool(cfg, AdapterRegistry(), slots=2, device="cpu")


def test_adapter_registry_refuses_ragged_ranks(mdl):
    _, _, cfg, _ = mdl
    reg = AdapterRegistry()
    reg.register("r4", make_adapter(cfg, rank=4, seed=1))
    with pytest.raises(ValueError, match="rank"):
        reg.register("r8", make_adapter(cfg, rank=8, seed=2))
    with pytest.raises(KeyError, match="unknown adapter"):
        reg.get("nope")


@pytest.fixture(scope="module")
def pools(mdl):
    """Both packages' pools holding ad_a in slot 1 and ad_b in slot 2."""
    jcfg, _, cfg, _ = mdl
    treg, jreg = _regs(cfg)
    tpool = AdapterPool(cfg, treg, 3, device="cpu")
    jpool = JaxPool(jcfg, jreg, 3)
    for name in ("ad_a", "ad_b"):
        assert tpool.acquire(name) == jpool.acquire(name)
    tarr, jarr = tpool.device_arrays(), jpool.device_arrays()
    for k in tarr:
        np.testing.assert_array_equal(tarr[k].numpy(), np.asarray(jarr[k]))
    return tarr, jarr


def test_adapter_qv_matches_jax(mdl, pools):
    _, jp, _, tp = mdl
    tarr, jarr = pools
    rng = np.random.RandomState(5)
    d = SMALL["dim"]
    for shape, idx in (((3, d), np.array([0, 2, 1], np.int32)),
                       ((2, 3, d), np.array([1, 2], np.int32)),
                       ((1, 5, d), 2)):
        h = rng.randn(*shape).astype(np.float32)
        for li in range(SMALL["layers"]):
            jq, jv = J._adapter_qv(jnp.asarray(h), jp["blocks"][li], li,
                                   jarr, jnp.asarray(idx))
            tq, tv = T._adapter_qv(torch.from_numpy(h), tp["blocks"][li],
                                   li, tarr, torch.from_numpy(idx)
                                   if isinstance(idx, np.ndarray) else idx)
            np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **_TOL)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **_TOL)
    # the zero adapter adds exact zeros
    h = torch.from_numpy(rng.randn(2, d).astype(np.float32))
    q0, v0 = T._adapter_qv(h, tp["blocks"][0], 0, tarr,
                           torch.zeros(2, dtype=torch.int32))
    assert torch.equal(q0, h @ tp["blocks"][0]["wq"])
    assert torch.equal(v0, h @ tp["blocks"][0]["wv"])


def _rand_pool(cfg, NB, Bt, seed):
    rng = np.random.RandomState(seed)
    dh = cfg.dim // cfg.heads
    return [{"k": rng.randn(NB, Bt, cfg.heads, dh).astype(np.float32),
             "v": rng.randn(NB, Bt, cfg.heads, dh).astype(np.float32)}
            for _ in range(cfg.layers)]


def _caches(pool):
    return ([{b: jnp.asarray(a) for b, a in kv.items()} for kv in pool],
            [{b: torch.from_numpy(a.copy()) for b, a in kv.items()}
             for kv in pool])


def _close_all(tl, tc, jl, jc):
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **_TOL)
    for a, b in zip(tc, jc):
        for band in a:
            np.testing.assert_allclose(a[band].numpy(), np.asarray(b[band]),
                                       **_TOL)


@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
def test_paged_primitives_with_adapters_match_jax(mdl, pools, which):
    jcfg, jp, cfg, tp = mdl
    tarr, jarr = pools
    NB, Bt = 10, 8
    jc, tc = _caches(_rand_pool(cfg, NB, Bt, 7))
    tables = np.array([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]],
                      np.int32)
    aidx = np.array([1, 0, 2], np.int32)
    jidx, tidx = jnp.asarray(aidx), torch.from_numpy(aidx)
    jt, tt = jnp.asarray(tables), torch.from_numpy(tables)
    if which == "decode":  # slot 2 parked
        pos = np.array([9, 20, 4 * Bt], np.int32)
        tok = np.array([7, 11, 42], np.int32)
        jl, jc = J.paged_decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                     jt, jc, jcfg, adapters=jarr,
                                     adapter_idx=jidx, kernel="gather")
        tl, tc = T.paged_decode_step(tp, torch.from_numpy(tok),
                                     torch.from_numpy(pos), tt, tc, cfg,
                                     adapters=tarr, adapter_idx=tidx,
                                     kernel="fused")
    elif which == "verify":  # a K=3 window, one row past its budget
        window = np.array([[5, 6, 7], [8, 9, 10], [1, 2, 3]], np.int32)
        vpos = np.array([12, 9, 3], np.int32)
        wpos = vpos[:, None] + np.arange(3)[None, :]
        wpos[1, 2] = 4 * Bt
        jl, jc = J.paged_verify_step(jp, jc, jnp.asarray(window),
                                     jnp.asarray(vpos), jnp.asarray(wpos),
                                     jt, jcfg, adapters=jarr,
                                     adapter_idx=jidx, kernel="gather")
        tl, tc = T.paged_verify_step(tp, tc, torch.from_numpy(window),
                                     torch.from_numpy(vpos),
                                     torch.from_numpy(wpos), tt, cfg,
                                     adapters=tarr, adapter_idx=tidx,
                                     kernel="fused")
    else:  # one slot, a scalar adapter index, padded rows parked
        chunk = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
        jl, jc = J.paged_prefill_chunk(jp, jc, jnp.asarray(chunk),
                                       jnp.int32(10), jt[1], jcfg,
                                       true_len=jnp.int32(5), adapters=jarr,
                                       adapter_idx=jnp.int32(2),
                                       kernel="gather")
        tl, tc = T.paged_prefill_chunk(tp, tc, torch.from_numpy(chunk), 10,
                                       tt[1], cfg, true_len=5,
                                       adapters=tarr, adapter_idx=2,
                                       kernel="fused")
    _close_all(tl, tc, jl, jc)


def _tokens(eng, plan, n=6):
    hs = [eng.submit(p, n, adapter=a) for a, p in plan]
    eng.run()
    return [list(map(int, h.tokens)) for h in hs]


def test_zero_adapter_engine_token_identical_to_no_registry(mdl):
    _, _, cfg, tp = mdl
    treg, _ = _regs(cfg)
    rng = np.random.RandomState(0)
    plan = [(None, rng.randint(0, SMALL["vocab"], t).astype(np.int32))
            for t in (3, 7, 12)]
    with_pool = ServingEngine(tp, cfg, max_slots=3, adapter_registry=treg,
                              adapter_slots=3, device="cpu")
    bare = ServingEngine(tp, cfg, max_slots=3, device="cpu")
    assert _tokens(with_pool, plan) == _tokens(bare, plan)
    assert with_pool.metrics.report()["adapter_pool"]["misses"] == 0


def test_n_tenants_batched_equal_sequential_and_jax(mdl):
    """Tenants batched in one engine, through a 2-payload-slot pool that
    must LRU-evict in the second wave, emit what per-tenant sequential
    engines emit; the first wave also equals the JAX engine's."""
    jcfg, jp, cfg, tp = mdl
    treg, jreg = _regs(cfg, names=("ad_a", "ad_b", "ad_c"))
    rng = np.random.RandomState(1)
    prompts = [rng.randint(0, SMALL["vocab"], t).astype(np.int32)
               for t in (4, 9, 6, 11)]
    plan = [("ad_a", prompts[0]), ("ad_b", prompts[1]), (None, prompts[2]),
            ("ad_a", prompts[3])]
    kw = dict(max_slots=2, adapter_slots=3)
    eng = ServingEngine(tp, cfg, adapter_registry=treg, device="cpu", **kw)
    wave1 = _tokens(eng, plan)
    wave2 = _tokens(eng, [("ad_c", prompts[0]), ("ad_a", prompts[1])])
    assert eng._adapter_pool.evictions >= 1
    assert wave1 == _tokens(JaxEngine(jp, jcfg, adapter_registry=jreg,
                                      paged_kernel="gather", **kw), plan)
    for (a, p), got in zip(plan + [("ad_c", prompts[0]),
                                   ("ad_a", prompts[1])], wave1 + wave2):
        seq = ServingEngine(tp, cfg, max_slots=1, adapter_registry=treg,
                            adapter_slots=3, device="cpu")
        assert _tokens(seq, [(a, p)]) == [got], a
    # different adapters really produce different tokens
    assert wave1[0] != wave1[2]


def test_adapter_requests_never_share_the_prefix_trie(mdl):
    _, _, cfg, tp = mdl
    treg, _ = _regs(cfg)
    rng = np.random.RandomState(2)
    prompt = np.concatenate([rng.randint(0, SMALL["vocab"], 16),
                             rng.randint(0, SMALL["vocab"], 4)]) \
        .astype(np.int32)
    kw = dict(max_slots=1, kv_block_tokens=4, prefix_cache_tokens=256,
              adapter_registry=treg, adapter_slots=3, device="cpu")
    eng = ServingEngine(tp, cfg, **kw)
    plan = [(None, prompt), ("ad_a", prompt), ("ad_b", prompt),
            (None, prompt)]
    got = _tokens(eng, plan, n=5)
    pc = eng.prefix_cache
    assert pc.hits == 1 and pc.misses == 1  # only the base pair
    for (a, p), toks in zip(plan, got):
        assert _tokens(ServingEngine(tp, cfg, **kw), [(a, p)], n=5) == [toks]


def test_engine_refuses_unknown_and_poolless_adapters(mdl):
    _, _, cfg, tp = mdl
    treg, _ = _regs(cfg)
    eng = ServingEngine(tp, cfg, max_slots=1, adapter_registry=treg,
                        adapter_slots=3, device="cpu")
    with pytest.raises(ValueError, match="unknown adapter"):
        eng.submit(np.arange(4, dtype=np.int32), 3, adapter="nope")
    bare = ServingEngine(tp, cfg, max_slots=1, device="cpu")
    with pytest.raises(ValueError, match="no adapter pool"):
        bare.submit(np.arange(4, dtype=np.int32), 3, adapter="ad_a")
    assert eng.queue_depth == 0 and bare.queue_depth == 0


def test_adapter_starved_admission_queues(mdl):
    """Every payload slot pinned by a live request: the next adapter
    request stays queued (backpressure), then completes after a
    retirement frees a slot."""
    _, _, cfg, tp = mdl
    treg, _ = _regs(cfg, names=("a", "b"))
    eng = ServingEngine(tp, cfg, max_slots=2, adapter_registry=treg,
                        adapter_slots=2, device="cpu")
    p = np.arange(1, 6, dtype=np.int32)
    ha = eng.submit(p, 6, adapter="a")
    hb = eng.submit(p, 6, adapter="b")
    eng.step()
    assert eng.queue_depth == 1 and eng.live_slots == 1
    eng.run()
    assert ha.finish_reason == hb.finish_reason == "budget"
    assert eng._adapter_pool.evictions == 1
