"""Decode windows and async dispatch in the port
(paddle_tpu_torch/serving/engine.py `decode_window`/`async_dispatch`,
models/transformer.py `decode_window_retire`, metrics.py's per-token
EWMA and busy union) against the JAX engine on the same weights.

* Token identity: for K in {1, 2, 4}, sync and async, greedy AND sampled
  requests (one retiring on EOS mid-window) emit the tokens of the
  port's one-token engine and of the JAX engine at the same K, in the
  same number of decode steps.
* Hard paths under a window: EOS mid-window, prefix aliasing and
  copy-on-write, int8 KV (against the JAX engine too), a trap in the
  first window (nothing emitted) and one forged mid-window (iteration j
  poisons only tokens >= j), expiry at the window boundary, spec decode
  refused with either knob, one decode function per engine.
* The sync-free write: `_RowWriter` drops parked rows without reading
  anything back (no nonzero, no item, no boolean mask), writes exactly
  what the old masked write wrote, and a steady chained window dispatch
  issues no host-reading op and uploads no band.
"""

import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax

from paddle_tpu.models import transformer as J
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving.metrics import ServingMetrics as JaxMetrics
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel.kernel_utils import raw_bytes
from paddle_tpu_torch.serving import IntegrityError, ServingEngine
from paddle_tpu_torch.serving.metrics import ServingMetrics
from torch_parity import models

torch.set_num_threads(2)

SMALL = dict(vocab=128, dim=64, heads=4, layers=2, max_len=128)


@pytest.fixture(scope="module")
def mdl():
    return models(0, **SMALL)


def _oracle(tp, cfg, prompt, n):
    out = T.generate(tp, torch.from_numpy(prompt[None]).long(), cfg, n)
    return out[0, len(prompt):].tolist()


def _trace(tp, cfg):
    """Six staggered requests, odd ones sampled at T 0.8, budgets that
    are no multiple of any K (every variant retires slots mid-window);
    request 2 retires on EOS: its own third greedy token."""
    rng = np.random.RandomState(7)
    reqs = []
    for i, (t0, n) in enumerate([(3, 6), (7, 9), (12, 8), (5, 11), (9, 4),
                                 (17, 7)]):
        reqs.append(dict(prompt=rng.randint(0, SMALL["vocab"], t0)
                         .astype(np.int32), max_new_tokens=n,
                         temperature=0.8 if i % 2 else 0.0, seed=100 + i))
    reqs[2]["eos_id"] = _oracle(tp, cfg, reqs[2]["prompt"], 3)[2]
    return reqs


def _serve(eng, reqs):
    hs = []
    for i, r in enumerate(reqs):
        hs.append(eng.submit(**r))
        if i % 2:
            eng.step()  # arrivals keep landing while others decode
    eng.run()
    return ([list(map(int, h.tokens)) for h in hs],
            [h.finish_reason for h in hs])


@pytest.fixture(scope="module")
def one_token(mdl):
    _, _, cfg, tp = mdl
    reqs = _trace(tp, cfg)
    return reqs, _serve(ServingEngine(tp, cfg, max_slots=2, device="cpu"),
                        reqs)


@pytest.mark.parametrize("async_on", [False, True])
@pytest.mark.parametrize("K", [1, 2, 4])
def test_window_tokens_match_jax_and_one_token_engine(mdl, one_token, K,
                                                      async_on):
    jcfg, jp, cfg, tp = mdl
    reqs, want = one_token
    teng = ServingEngine(tp, cfg, max_slots=2, decode_window=K,
                         async_dispatch=async_on, device="cpu")
    jeng = JaxEngine(jp, jcfg, max_slots=2, decode_window=K,
                     async_dispatch=async_on, paged_kernel="gather")
    got = _serve(teng, reqs)
    assert got == want
    assert got == _serve(jeng, reqs)
    assert "eos" in got[1] and "budget" in got[1]
    assert teng.metrics.decode_steps == jeng.metrics.decode_steps
    assert teng.metrics.tokens_out == jeng.metrics.tokens_out
    if K > 1 or async_on:
        assert teng._window_fn is not None


def test_eos_mid_window_retires_on_the_device(mdl):
    _, _, cfg, tp = mdl
    p = np.arange(2, 9, dtype=np.int32)
    eos = _oracle(tp, cfg, p, 12)[2]  # generated index 2: mid-window
    base = ServingEngine(tp, cfg, max_slots=1, device="cpu")
    hb = base.submit(p, 12, eos_id=eos)
    hb.result()
    assert hb.tokens[-1] == eos and len(hb.tokens) < 12
    for async_on in (False, True):
        eng = ServingEngine(tp, cfg, max_slots=1, decode_window=4,
                            async_dispatch=async_on, device="cpu")
        h = eng.submit(p, 12, eos_id=eos)
        eng.run()
        assert h.tokens == hb.tokens and h.finish_reason == "eos"
        assert eng.kv_blocks_in_use == 0


def test_spec_decode_refused_with_either_knob(mdl):
    _, _, cfg, tp = mdl
    for kw in ({"decode_window": 4}, {"async_dispatch": True}):
        with pytest.raises(ValueError, match="spec_draft_len composes"):
            ServingEngine(tp, cfg, spec_draft_len=3, device="cpu", **kw)
    with pytest.raises(ValueError, match="decode_window"):
        ServingEngine(tp, cfg, decode_window=0, device="cpu")


def test_one_decode_function_per_engine(mdl, monkeypatch):
    """A window engine never runs the one-token step, and a one-token
    engine never builds or launches a window."""
    _, _, cfg, tp = mdl
    p = np.arange(1, 9, dtype=np.int32)

    def refuse(*a, **k):
        raise AssertionError("the engine ran the other decode function")

    win = ServingEngine(tp, cfg, max_slots=2, decode_window=4,
                        device="cpu")
    monkeypatch.setattr(win, "_decode_step", refuse)
    assert win.submit(p, 6).result().shape == (14,)
    plain = ServingEngine(tp, cfg, max_slots=2, device="cpu")
    assert plain._window_fn is None
    monkeypatch.setattr(plain, "_launch_window", refuse)
    assert plain.submit(p, 6).result().shape == (14,)


def test_prefix_alias_and_cow_under_window(mdl):
    """The whole-prompt re-admit privatises the shared tail block at
    K=4 async: the same copy-on-write counts as the one-token engine,
    and the generate() tokens."""
    _, _, cfg, tp = mdl
    p = np.random.RandomState(21).randint(0, SMALL["vocab"], 8) \
        .astype(np.int32)  # two blocks of 4
    want = _oracle(tp, cfg, p, 5)
    eng = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=4,
                        prefix_cache_tokens=64, decode_window=4,
                        async_dispatch=True, device="cpu")
    cows = []
    for _ in range(3):
        h = eng.submit(p, 5)
        eng.run()
        assert h.tokens == want
        cows.append(eng.metrics.cow_blocks)
    assert cows == [0, 1, 2]
    assert eng.prefix_cache.stats()["hits"] >= 2


def test_int8_kv_under_window_matches_jax(mdl):
    """Quantized blocks commit their scales at open inside the window's
    writes: the K=4 async int8 engine emits the one-token int8 engine's
    tokens and the JAX int8 engine's at K=4."""
    jcfg, jp, cfg, tp = mdl
    rng = np.random.RandomState(9)
    reqs = [dict(prompt=rng.randint(0, SMALL["vocab"], t0).astype(np.int32),
                 max_new_tokens=n) for t0, n in ((5, 8), (12, 6), (7, 9))]
    kw = dict(max_slots=2, kv_block_tokens=8, kv_quant="int8")
    base = _serve(ServingEngine(tp, cfg, device="cpu", **kw), reqs)
    got = _serve(ServingEngine(tp, cfg, device="cpu", decode_window=4,
                               async_dispatch=True, **kw), reqs)
    assert got == base
    assert got == _serve(JaxEngine(jp, jcfg, decode_window=4,
                                   async_dispatch=True,
                                   paged_kernel="gather", **kw), reqs)


def test_trap_in_first_window_emits_nothing(mdl):
    _, _, cfg, tp = mdl
    prompt = np.arange(1, 6, dtype=np.int32)
    bad = dict(tp, embed=tp["embed"].clone())
    bad["embed"][int(prompt[-1])] = float("nan")
    eng = ServingEngine(bad, cfg, max_slots=2, decode_window=4,
                        async_dispatch=True, device="cpu")
    h = eng.submit(prompt, 8)
    with pytest.raises(IntegrityError) as ei:
        h.result()
    assert ei.value.kind == "trap"
    assert h.tokens == []


def test_trap_mid_window_poisons_only_the_tail(mdl):
    """Traps are judged per iteration before that iteration's tokens
    emit: a trip forged at iteration 2 of a real dispatched window lets
    iterations 0 and 1 emit (still the generate() tokens)."""
    _, _, cfg, tp = mdl
    p = np.arange(1, 8, dtype=np.int32)
    want = _oracle(tp, cfg, p, 16)
    K, S = 4, 2
    eng = ServingEngine(tp, cfg, max_slots=S, decode_window=K,
                        device="cpu")
    h = eng.submit(p, 16)
    while not h.tokens:
        eng.step()
    n0 = len(h.tokens)
    s = next(i for i, hh in enumerate(eng._slot_req) if hh is h)
    rec = eng._dispatch_window()  # a real window off the current state
    flat = rec["packed"].clone()
    flat[:(2 * K + 4) * S].view(2 * K + 4, S)[K + 4 + 2, s] = 1
    rec["packed"] = flat
    with pytest.raises(IntegrityError) as ei:
        eng._sync_window(rec)
    assert ei.value.kind == "trap"
    assert h.tokens == want[:n0 + 2]


@pytest.mark.parametrize("async_on", [False, True])
def test_expiry_at_window_boundary_keeps_pre_window_tokens(mdl, async_on):
    """A deadline dying mid-window expires the request at the next
    window boundary: every token already synced is kept, nothing from a
    discarded in-flight window leaks in, and the engine serves on."""
    _, _, cfg, tp = mdl
    p = np.arange(3, 10, dtype=np.int32)
    want = _oracle(tp, cfg, p, 24)
    eng = ServingEngine(tp, cfg, max_slots=2, decode_window=4,
                        async_dispatch=async_on, device="cpu")
    h = eng.submit(p, 24, deadline_at=time.monotonic() + 3600.0)
    while len(h.tokens) < 5:
        eng.step()
    n0 = len(h.tokens)
    assert (n0 - 1) % 4 == 0  # the prefill token + whole windows only
    h.deadline_at = time.monotonic() - 1.0
    eng.step()
    assert h.done and h.finish_reason == "expired"
    assert h.tokens == want[:n0]
    assert eng.metrics.expired == 1
    h2 = eng.submit(p, 6)
    eng.run()
    assert h2.tokens == want[:6]
    assert eng.kv_blocks_in_use == 0


def test_step_ewma_per_token_and_busy_union_match_the_reference():
    ours, ref = ServingMetrics(2), JaxMetrics(2)
    for dt, k in ((0.8, 8), (0.8, 8), (0.1, 1), (0.3, 4)):
        ours.observe_step(dt, tokens=k)
        ref.observe_step(dt, tokens=k)
        assert ours.step_ewma_s == ref.step_ewma_s
    one = ServingMetrics(2)
    one.observe_step(0.1)
    assert one.step_ewma_s == pytest.approx(0.1)
    # overlapping dispatch->sync spans (async windows) count once
    for span in ((0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.5, 2.7)):
        ours.observe_device_interval(*span)
        ref.observe_device_interval(*span)
    assert ours.device_busy_s == ref.device_busy_s == pytest.approx(2.5)


def test_decode_window_retire_matches_jax():
    rng = np.random.RandomState(3)
    S = 64
    alive = rng.rand(S) < 0.7
    nxt = rng.randint(0, 20, S).astype(np.int32)
    pos = rng.randint(0, 30, S).astype(np.int32)
    limits = pos + rng.randint(0, 4, S).astype(np.int32)
    eos = np.where(rng.rand(S) < 0.5, rng.randint(0, 20, S), -1) \
        .astype(np.int32)
    eos[:4] = nxt[:4]  # some certain EOS hits
    ja, jpos = J.decode_window_retire(alive, nxt, pos, limits, eos)
    ta, tpos = T.decode_window_retire(*(torch.from_numpy(a) for a in (
        alive, nxt, pos, limits, eos)))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    assert tpos.dtype == torch.int32


# ---------------------------------------------------------------------
# the sync-free paged write
# ---------------------------------------------------------------------

# ops that read device data back to the host (or imply it)
_HOST_READS = {"nonzero", "_local_scalar_dense", "is_nonzero",
               "masked_select", "equal", "unique", "_unique2", "item"}


class _NoHostReads(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_READS:
            raise AssertionError("%s reads device data back" % name)
        if name.startswith("index") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for a in args if isinstance(a, (list, tuple)) for i in a):
            raise AssertionError("%s with a boolean mask" % name)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kvq", ["none", "int8", "fp8"])
def test_paged_primitives_read_nothing_back(mdl, kvq):
    _, _, cfg, tp = mdl
    NB, Bt = 12, 4
    cache = T.init_paged_kv_cache(cfg, NB, Bt, kv_quant=kvq, device="cpu")
    tables = torch.tensor([[0, 1, 2, -1], [3, 4, -1, -1], [5, -1, -1, -1]],
                          dtype=torch.int32)
    tok = torch.tensor([5, 6, 7], dtype=torch.int32)
    pos = torch.tensor([9, 16, 2], dtype=torch.int32)  # slot 1 parked
    with _NoHostReads():
        T.paged_prefill_chunk(tp, cache, torch.arange(8, dtype=torch.int32),
                              0, tables[0], cfg, true_len=6,
                              kernel="fused", kv_quant=kvq)
        T.paged_decode_step(tp, tok, pos, tables, cache, cfg,
                            kernel="fused", kv_quant=kvq)
        win = torch.arange(6, dtype=torch.int32).reshape(3, 2)
        T.paged_verify_step(tp, cache, win, pos, pos[:, None] + torch.tensor(
            [0, 1], dtype=torch.int32), tables, cfg, kernel="fused",
            kv_quant=kvq)


def _masked_write_oracle(buf, pk, off, rows, NB):
    """The write the sync-free writer replaced: the in-range rows only,
    selected with a host-side mask."""
    out = raw_bytes(buf).clone()
    vals = raw_bytes(rows.to(buf.dtype))
    for i in range(pk.shape[0]):
        if int(pk[i]) < NB:
            out[int(pk[i]), int(off[i])] = vals[i]
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float8_e4m3fn])
def test_row_writer_drops_parked_rows_like_the_masked_write(dtype):
    rng = np.random.RandomState(1)
    NB, Bt, H, dh = 6, 4, 2, 8
    init = torch.from_numpy(rng.randn(NB, Bt, H, dh).astype(np.float32))
    # parked rows (pk == NB) sit beside live rows of the same blocks, and
    # one call has no live row at all
    cases = [([2, 6, 2, 0, 6], [1, 3, 2, 0, 1]), ([6, 6, 6], [0, 1, 2]),
             ([5, 6], [3, 0]), ([6, 1], [0, 0])]
    for pks, offs in cases:
        buf = (init * 10).to(dtype)
        pk = torch.tensor(pks)
        off = torch.tensor(offs)
        rows = torch.from_numpy(rng.randn(len(pks), H, dh).astype(
            np.float32) * 10)
        want = _masked_write_oracle(buf, pk, off, rows, NB)
        with _NoHostReads():
            T._RowWriter(pk, off, NB).write(buf, rows)
        assert torch.equal(raw_bytes(buf), want), (pks, offs)


def test_steady_chained_dispatch_uploads_and_reads_nothing(mdl):
    """Once no band is dirty, an async window chained off the pending one
    issues no host-reading op and uploads no band."""
    _, _, cfg, tp = mdl
    eng = ServingEngine(tp, cfg, max_slots=2, decode_window=2,
                        async_dispatch=True, device="cpu")
    rng = np.random.RandomState(4)
    for i in range(2):
        eng.submit(rng.randint(0, SMALL["vocab"], 6).astype(np.int32), 40,
                   temperature=0.8 * i, seed=i)
    launches = []
    real = eng._launch_window

    def watched(prev, live):
        steady = prev is not None and not eng._dirty
        up0 = eng.metrics.band_uploads
        if steady:
            with _NoHostReads():
                rec = real(prev, live)
            assert eng.metrics.band_uploads == up0
        else:
            rec = real(prev, live)
        launches.append(steady)
        return rec

    eng._launch_window = watched
    eng.run()
    assert sum(launches) >= 5
