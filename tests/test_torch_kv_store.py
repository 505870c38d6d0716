"""The port's durable KV tier (paddle_tpu_torch/serving/kv_store.py and
the engine's spill, handoff import and warm start) against the JAX
package.

* Store contract, the reference suite's cases against the port's own
  copy: crc-verified get with sticky quarantine, chain_fetch stopping at
  the first hole, leaf-first LRU under a byte budget, the injected
  store_corrupt@N / store_trunc@N faults, durability with a torn tail
  and mid-file garbage skipped, one geometry per store, compaction.
* One on-disk format: a store file either package writes loads in the
  other record for record, and the same puts write the same bytes.
* Engine: a published prefix spills as fingerprinted records; a fresh
  engine imports the package with zero closed-block tokens recomputed;
  a fingerprint-failing package falls back to re-prefill with the same
  tokens and quarantines the liar (a liar mid-package keeps the blocks
  before it, counted); a warm start serves the prefix
  without re-decoding it and quarantines a corrupt entry with its
  subtree; records a JAX engine spilled serve the port's engine with
  the generate() tokens.
"""

import numpy as np
import pytest
import torch

import jax

from paddle_tpu.distributed import fault_injection as jfi
from paddle_tpu.serving import KVBlockStore as JaxStore
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu_torch.distributed import fault_injection as fi
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import (KVBlockStore, ServingEngine, fold_key,
                                      make_block_record, payload_crc)
from torch_parity import models

torch.set_num_threads(2)

BT = 4  # block geometry used throughout
SMALL = dict(vocab=128, dim=64, heads=4, layers=2, max_len=128)


def _chain(*blocks, payload=b"0123456789abcdef", fp=1.0):
    """Chained records for token blocks, parent-linked in order."""
    recs, parent = [], 0
    for blk in blocks:
        key = fold_key(parent, tuple(blk))
        recs.append(make_block_record(key, parent, blk, fp, payload, []))
        parent = key
    return recs


# ---------------------------------------------------------------------
# store contract (host only)
# ---------------------------------------------------------------------

def test_put_get_roundtrip_idempotent():
    st = KVBlockStore(block_tokens=BT)
    (r0,) = _chain((1, 2, 3, 4))
    assert st.put(r0)
    assert st.put(r0)  # idempotent per key
    got = st.get(r0["key"])
    assert got is not None and got["payload"] == r0["payload"]
    s = st.stats()
    assert s["records"] == 1 and s["puts"] == 1 and s["hits"] == 1
    assert st.get(999) is None and st.stats()["misses"] == 1
    assert r0["key"] in st.summary()


def test_chain_fetch_walks_and_stops_at_hole():
    st = KVBlockStore(block_tokens=BT)
    b0, b1, b2 = (1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12)
    for r in _chain(b0, b1, b2):
        assert st.put(r)
    toks = list(b0 + b1 + b2) + [13]  # partial tail block ignored
    assert [r["tokens"] for r in st.chain_fetch(toks)] == [b0, b1, b2]
    assert st.evict(fold_key(fold_key(0, b0), b1))
    assert [r["tokens"] for r in st.chain_fetch(toks)] == [b0]


def test_chain_fetch_token_mismatch_guard():
    st = KVBlockStore(block_tokens=BT)
    blk_a, blk_b = (1, 2, 3, 4), (5, 6, 7, 8)
    rec = make_block_record(fold_key(0, blk_a), 0, blk_b, 1.0, b"x" * 8, [])
    assert st.put(rec)
    assert st.chain_fetch(list(blk_a)) == []


def test_leaf_first_eviction_never_orphans_a_chain():
    pay = b"p" * 16
    st = KVBlockStore(byte_budget=2 * len(pay), block_tokens=BT)
    ra, rb = _chain((1, 2, 3, 4), (5, 6, 7, 8), payload=pay)
    assert st.put(ra) and st.put(rb)
    (rc,) = _chain((9, 9, 9, 9), payload=pay)
    assert st.put(rc)
    assert st.get(ra["key"]) is not None
    assert st.get(rc["key"]) is not None
    assert st.get(rb["key"]) is None
    assert st.stats()["evictions"] == 1


def test_oversize_record_refused():
    st = KVBlockStore(byte_budget=8, block_tokens=BT)
    (r0,) = _chain((1, 2, 3, 4), payload=b"way-too-big-payload")
    assert not st.put(r0)
    assert st.stats()["records"] == 0


def test_store_fault_drills_corrupt_and_trunc():
    for spec, n_bad in (("store_corrupt@2", 2), ("store_trunc@1", 1)):
        st = KVBlockStore(block_tokens=BT,
                          fault_injector=fi.FaultInjector(spec))
        r1, r2 = _chain((1, 2, 3, 4), (5, 6, 7, 8))
        assert st.put(r1) and st.put(r2)
        bad = (r1, r2)[n_bad - 1]
        ok = (r1, r2)[2 - n_bad]
        assert st.get(bad["key"]) is None, spec
        assert st.get(ok["key"]) is not None, spec
        s = st.stats()
        assert s["quarantined"] == 1 and s["quarantines"] == 1, spec
        assert not st.put(bad)  # sticky
        assert st.get(bad["key"]) is None


def test_durability_roundtrip_and_sticky_quarantine(tmp_path):
    d = str(tmp_path / "store")
    st = KVBlockStore(dir=d, block_tokens=BT)
    b0, b1 = (1, 2, 3, 4), (5, 6, 7, 8)
    r0, r1 = _chain(b0, b1)
    assert st.put(r0) and st.put(r1)
    st.quarantine(r1["key"])
    st.close()
    st2 = KVBlockStore(dir=d, block_tokens=BT)
    assert st2.stats()["durable"]
    assert [r["tokens"] for r in st2.chain_fetch(list(b0 + b1))] == [b0]
    assert not st2.put(r1)
    st2.close()


def test_torn_tail_healed_midfile_garbage_skipped(tmp_path):
    d = str(tmp_path / "store")
    st = KVBlockStore(dir=d, block_tokens=BT)
    r0, r1, r2 = _chain((1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12))
    for r in (r0, r1, r2):
        assert st.put(r)
    st.close()
    path = str(tmp_path / "store" / "store.jsonl")
    lines = open(path).read().splitlines()
    lines[2] = lines[2][: len(lines[2]) // 2]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        f.write('{"kind": "put", "key": 123, "torn')  # no newline
    st2 = KVBlockStore(dir=d, block_tokens=BT)
    assert st2.stats()["corrupt_dropped"] == 2
    got = st2.chain_fetch([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12])
    assert [r["tokens"] for r in got] == [(1, 2, 3, 4)]
    assert st2.get(r2["key"]) is not None
    st2.close()


def test_one_store_one_geometry(tmp_path):
    d = str(tmp_path / "store")
    KVBlockStore(dir=d, block_tokens=BT).close()
    with pytest.raises(ValueError, match="block geometry"):
        KVBlockStore(dir=d, block_tokens=8)


def test_compaction_rewrites_to_live_set(tmp_path):
    d = str(tmp_path / "store")
    st = KVBlockStore(dir=d, block_tokens=BT)
    for i in range(12):
        (r,) = _chain((i, i, i, i))
        assert st.put(r)
        if i < 10:
            assert st.evict(r["key"])
    assert st.stats()["compactions"] >= 1
    live = {r["key"] for r in st.iter_chains()}
    st.close()
    st2 = KVBlockStore(dir=d, block_tokens=BT)
    assert {r["key"] for r in st2.iter_chains()} == live
    assert st2.stats()["records"] == len(live)
    st2.close()


def test_iter_chains_parents_before_children():
    st = KVBlockStore(block_tokens=BT)
    recs = _chain((1, 2, 3, 4), (5, 6, 7, 8), (9, 10, 11, 12))
    for r in reversed(recs):  # admit out of order
        assert st.put(r)
    seen = set()
    for r in st.iter_chains():
        assert r["parent"] == 0 or r["parent"] in seen
        seen.add(r["key"])
    assert seen == {r["key"] for r in recs}


# ---------------------------------------------------------------------
# one on-disk format across the packages
# ---------------------------------------------------------------------

def _churn(store_cls, d, injector=None):
    """The same puts, evictions and quarantine through one store class."""
    st = store_cls(dir=d, block_tokens=BT, fault_injector=injector)
    rng = np.random.RandomState(3)
    recs = _chain(*[tuple(int(t) for t in rng.randint(0, 50, BT))
                    for _ in range(5)],
                  payload=rng.bytes(24), fp=12.5)
    for r in recs:
        st.put(r)
    st.evict(recs[-1]["key"])
    st.quarantine(recs[3]["key"])
    st.close()
    return recs


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_file_loads_record_for_record_across_packages(tmp_path,
                                                            writer):
    d = str(tmp_path / "store")
    w_cls, r_cls = ((JaxStore, KVBlockStore) if writer == "jax"
                    else (KVBlockStore, JaxStore))
    recs = _churn(w_cls, d)
    a, b = w_cls(dir=d, block_tokens=BT), r_cls(dir=d, block_tokens=BT)
    assert a.iter_chains() == b.iter_chains()
    assert [r["key"] for r in b.iter_chains()] == [r["key"]
                                                   for r in recs[:3]]
    sa, sb = a.stats(), b.stats()
    assert sa == sb and sb["quarantined"] == 1
    assert b.chain_fetch([t for r in recs for t in r["tokens"]]) == \
        recs[:3]
    a.close()
    b.close()


def test_same_puts_write_the_same_bytes(tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    _churn(JaxStore, dj, jfi.FaultInjector("store_corrupt@2"))
    _churn(KVBlockStore, dt, fi.FaultInjector("store_corrupt@2"))
    assert open(dj + "/store.jsonl", "rb").read() == \
        open(dt + "/store.jsonl", "rb").read()


# ---------------------------------------------------------------------
# engine: spill -> handoff import / fallback / warm start
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def mdl():
    return models(0, **SMALL)


def _oracle(tp, cfg, prompt, n):
    return T.generate(tp, torch.from_numpy(prompt[None]).long(), cfg,
                      n)[0, len(prompt):].tolist()


def _eng(tp, cfg, store, warm=False):
    return ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=BT,
                         prefix_cache_tokens=16 * BT, kv_fingerprints=True,
                         kv_store=store, kv_store_warm=warm, device="cpu")


def test_engine_spill_import_zero_recompute_and_fp_fallback(mdl):
    _, _, cfg, tp = mdl
    prompt = np.random.RandomState(0).randint(0, SMALL["vocab"], 3 * BT) \
        .astype(np.int32)
    want = _oracle(tp, cfg, prompt, 5)
    store = KVBlockStore(block_tokens=BT)
    src = _eng(tp, cfg, store)
    h = src.submit(prompt, 5)
    src.run()
    assert h.tokens == want
    assert src.metrics.store_spilled_blocks == 3
    package = store.chain_fetch(prompt)
    assert len(package) == 3
    assert package[0]["meta"][0] == ("0.k", "float32", (BT, 4, 16))

    # clean handoff: a fresh engine, cold trie, the package covers all
    tgt = _eng(tp, cfg, store)
    h2 = tgt.submit(prompt, 5, handoff=package)
    tgt.run()
    assert h2.tokens == want
    m = tgt.metrics
    assert m.tokens_recomputed_at_migration == 0
    assert m.handoff_imports == 1 and m.handoff_fallbacks == 0
    assert m.handoff_blocks_imported == 3
    assert m.prefill_tokens_computed == 1  # only the final prompt token
    assert h2.handoff_outcome == {"imported": 3 * BT, "fallback": False}

    # a lying record: the exponent byte of a payload value flipped and
    # the crc made honest over the rot: only the fingerprint sees it
    bad = [dict(r) for r in package]
    pay = bytearray(bad[0]["payload"])
    pay[3] ^= 0x7F
    bad[0]["payload"] = bytes(pay)
    bad[0]["crc"] = payload_crc(bad[0]["payload"])
    fb = _eng(tp, cfg, store)
    h3 = fb.submit(prompt, 5, handoff=bad)
    fb.run()
    assert h3.tokens == want
    m = fb.metrics
    assert m.handoff_fallbacks == 1 and m.handoff_imports == 0
    assert m.tokens_recomputed_at_migration > 0  # counted, never wrong
    assert h3.handoff_fallback and h3.handoff_outcome["fallback"]
    assert m.store_quarantined == 1
    assert store.stats()["quarantined"] == 1
    assert fb.kv_blocks_in_use == fb.prefix_cache.stats()["blocks"]

    # a liar in the middle: the blocks before it import (and count),
    # the rest re-prefill
    mid = [dict(r) for r in package]
    mid[1] = dict(mid[1], fp=mid[1]["fp"] + 1e3)
    part = _eng(tp, cfg, store)
    h4 = part.submit(prompt, 5, handoff=mid)
    part.run()
    assert h4.tokens == want
    m = part.metrics
    assert m.handoff_blocks_imported == 1 and m.handoff_fallbacks == 1
    assert h4.handoff_outcome == {"imported": BT, "fallback": True}
    assert m.prefill_tokens_computed == 3 * BT - BT


def test_engine_warm_start_and_corrupt_entry_quarantine(mdl):
    _, _, cfg, tp = mdl
    prompt = np.random.RandomState(1).randint(0, SMALL["vocab"], 3 * BT) \
        .astype(np.int32)
    want = _oracle(tp, cfg, prompt, 5)
    store = KVBlockStore(block_tokens=BT)
    src = _eng(tp, cfg, store)
    src.submit(prompt, 5)
    src.run()
    assert store.stats()["records"] >= 3
    warm = _eng(tp, cfg, store, warm=True)
    assert warm.metrics.store_warm_blocks == 3
    h = warm.submit(prompt, 5)
    warm.run()
    assert h.tokens == want
    assert warm.metrics.prefill_tokens_computed < len(prompt)

    # the middle record rots at rest: the warm start skips it AND its
    # child, quarantines, and the request still decodes the same tokens
    store2 = KVBlockStore(block_tokens=BT,
                          fault_injector=fi.FaultInjector("store_corrupt@2"))
    src2 = _eng(tp, cfg, store2)
    src2.submit(prompt, 5)
    src2.run()
    cold = _eng(tp, cfg, store2, warm=True)
    assert cold.metrics.store_warm_blocks == 1
    assert cold.metrics.store_quarantined >= 1
    assert store2.stats()["quarantined"] >= 1
    h2 = cold.submit(prompt, 5)
    cold.run()
    assert h2.tokens == want


def test_engine_store_refusals(mdl):
    _, _, cfg, tp = mdl
    with pytest.raises(ValueError, match="geometry"):
        _eng(tp, cfg, KVBlockStore(block_tokens=8))
    with pytest.raises(ValueError, match="prefix_cache_tokens"):
        ServingEngine(tp, cfg, kv_block_tokens=BT, device="cpu",
                      kv_store=KVBlockStore(block_tokens=BT))


def test_jax_spilled_records_serve_the_port_engine(mdl):
    """Records a JAX engine spilled warm the port's engine: each is
    judged by the fingerprint recomputed here, and the request decodes
    the generate() tokens whether a block imports or falls back."""
    jcfg, jp, cfg, tp = mdl
    prompt = np.random.RandomState(2).randint(0, SMALL["vocab"], 3 * BT) \
        .astype(np.int32)
    store = KVBlockStore(block_tokens=BT)
    jeng = JaxEngine(jp, jcfg, max_slots=2, kv_block_tokens=BT,
                     prefix_cache_tokens=16 * BT, kv_fingerprints=True,
                     kv_store=store, paged_kernel="gather")
    jeng.submit(prompt, 5)
    jeng.run()
    assert jeng.metrics.store_spilled_blocks == 3
    warm = _eng(tp, cfg, store, warm=True)
    assert warm.metrics.store_warm_blocks + \
        warm.metrics.store_quarantined == 3
    h = warm.submit(prompt, 5)
    warm.run()
    assert h.tokens == _oracle(tp, cfg, prompt, 5)
