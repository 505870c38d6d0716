"""Serving integrity in the port (paddle_tpu_torch/serving/integrity.py,
models/transformer.py `paged_block_fingerprint`, the engine's
`kv_fingerprints`) against the JAX package.

* `paged_block_fingerprint` matches the JAX reduction at rtol 1e-5 on
  f32 and int8 pools (scale rows included); a transposition inside a
  block and a swap of K with V each move it; `fp_digest` is bit-equal.
* Engine: fingerprints commit when a block is published and are checked
  when another request re-opens the aliased block; the `flip@` drill
  trips exactly there (kind "fingerprint"); a freed block drops its
  fingerprint; with fingerprints off the flip is silent corruption.
* `golden_trace` runs the port's `generate`: it equals the engine's
  greedy output and the JAX package's golden trace.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu.serving import integrity as jint
from paddle_tpu_torch.distributed.fault_injection import FaultInjector
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import (IntegrityError, ServingEngine,
                                      fp_digest, golden_trace)
from torch_parity import models

torch.set_num_threads(2)

SMALL = dict(vocab=128, dim=64, heads=4, layers=2, max_len=128)
PROMPT = np.array([5, 9, 2, 7, 1, 3, 8, 4, 6, 11, 10, 12], np.int32)
FP_KW = dict(max_slots=2, kv_block_tokens=4, prefix_cache_tokens=64,
             kv_fingerprints=True, device="cpu")


@pytest.fixture(scope="module")
def mdl():
    return models(0, **SMALL)


def _gen(tp, cfg, prompt, n):
    return T.generate(tp, torch.from_numpy(prompt[None]).long(), cfg,
                      n)[0].tolist()


def _pools(kvq, seed=0):
    rng = np.random.RandomState(seed)
    NB, Bt, H, dh = 6, 4, 4, 16
    out = []
    for _ in range(2):
        if kvq == "none":
            kv = {b: rng.randn(NB, Bt, H, dh).astype(np.float32)
                  for b in ("k", "v")}
        else:
            kv = {b: rng.randint(-127, 128, (NB, Bt, H, dh)).astype(np.int8)
                  for b in ("k", "v")}
            kv.update({b: rng.rand(NB, H).astype(np.float32)
                       for b in ("k_scale", "v_scale")})
        out.append(kv)
    return out


def _tc(pools):
    return [{b: torch.from_numpy(a.copy()) for b, a in kv.items()}
            for kv in pools]


@pytest.mark.parametrize("kvq", ["none", "int8"])
def test_block_fingerprint_matches_jax(kvq):
    pools = _pools(kvq)
    jc = [{b: jnp.asarray(a) for b, a in kv.items()} for kv in pools]
    tc = _tc(pools)
    for bid in range(6):
        want = float(J.paged_block_fingerprint(jc, jnp.int32(bid)))
        got = T.paged_block_fingerprint(tc, bid)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_fingerprint_moves_on_transposition_and_kv_swap():
    pools = _pools("none", seed=1)
    base = float(T.paged_block_fingerprint(_tc(pools), 2))
    swapped = [dict(kv) for kv in pools]
    k = swapped[1]["k"].copy()
    k[2, [0, 1]] = k[2, [1, 0]]  # two rows of one block transposed
    swapped[1]["k"] = k
    assert float(T.paged_block_fingerprint(_tc(swapped), 2)) != base
    kv_swap = [dict(kv) for kv in pools]
    kv_swap[0]["k"], kv_swap[0]["v"] = pools[0]["v"], pools[0]["k"]
    assert float(T.paged_block_fingerprint(_tc(kv_swap), 2)) != base
    # other blocks do not move it
    other = [dict(kv) for kv in pools]
    other[0]["k"] = pools[0]["k"].copy()
    other[0]["k"][3] += 1.0
    assert float(T.paged_block_fingerprint(_tc(other), 2)) == base


def test_fp_digest_bit_equal_to_the_reference():
    fps = [0.0, 1.5, -3.25e7, 12345.678, float(np.float32(0.1))]
    assert fp_digest(fps) == jint.fp_digest(fps)
    assert fp_digest([]) == jint.fp_digest([]) == "00000000"


def test_fingerprints_commit_at_publish_and_verify_at_alias(mdl):
    _, _, cfg, tp = mdl
    ref = _gen(tp, cfg, PROMPT, 6)
    eng = ServingEngine(tp, cfg, **FP_KW)
    assert list(eng.submit(PROMPT, 6).result()) == ref
    assert eng._fp.committed == len(PROMPT) // 4  # whole prompt blocks
    assert eng._fp.verified == 0
    assert list(eng.submit(PROMPT, 6).result()) == ref
    assert eng._fp.verified >= 1 and eng._fp.mismatches == 0
    rep = eng.metrics.report()["block_fingerprints"]
    assert rep["mismatches"] == 0 and rep["committed"] == 3
    with pytest.raises(ValueError, match="prefix_cache_tokens"):
        ServingEngine(tp, cfg, kv_fingerprints=True, device="cpu")


def test_flip_fault_trips_fingerprint_on_aliased_reopen(mdl):
    _, _, cfg, tp = mdl
    inj = FaultInjector("")
    eng = ServingEngine(tp, cfg, fault_injector=inj, **FP_KW)
    eng.submit(PROMPT, 6).result()      # publish + fingerprint
    inj.arm("flip@1")                   # corrupt a resident block
    with pytest.raises(IntegrityError) as ei:
        eng.submit(PROMPT, 6).result()  # aliased re-open spot-check
    assert ei.value.kind == "fingerprint"
    assert eng._fp.mismatches == 1


def test_fingerprint_dropped_when_block_is_freed(mdl):
    """A tiny trie budget forces eviction: the evicted block's
    fingerprint drops with it, so a recycled physical id is never judged
    against its previous tenant's checksum."""
    _, _, cfg, tp = mdl
    eng = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=4,
                        prefix_cache_tokens=8, kv_fingerprints=True,
                        kv_pool_blocks=8, device="cpu")
    p2 = np.array([7, 7, 8, 8, 9, 9, 1, 2], np.int32)
    for p in (PROMPT, p2, PROMPT, p2):
        assert list(eng.submit(p, 4).result()) == _gen(tp, cfg, p, 4)
    assert eng._fp.mismatches == 0
    assert eng.prefix_cache.evictions >= 1
    assert len(eng._fp._fp) <= eng.kv_blocks_in_use


def test_flip_with_fingerprints_off_is_silent(mdl):
    _, _, cfg, tp = mdl
    inj = FaultInjector("")
    eng = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=4,
                        prefix_cache_tokens=64, fault_injector=inj,
                        device="cpu")
    ref = _gen(tp, cfg, PROMPT, 6)
    assert list(eng.submit(PROMPT, 6).result()) == ref
    inj.arm("flip@1")
    assert list(eng.submit(PROMPT, 6).result()) != ref  # no raise


def test_golden_trace_equals_engine_greedy_and_jax(mdl):
    jcfg, jp, cfg, tp = mdl
    golden = golden_trace(tp, cfg, tuple(PROMPT), 5)
    eng = ServingEngine(tp, cfg, max_slots=2, device="cpu")
    out = list(eng.submit(PROMPT, 5).result())
    assert out[len(PROMPT):] == golden
    assert golden == jint.golden_trace(jp, jcfg, tuple(PROMPT), 5)
    assert golden_trace(tp, cfg) == jint.golden_trace(jp, jcfg)
