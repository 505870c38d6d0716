"""Quantized serving in the port (int8 / fp8 KV pools, int8 weights)
against the JAX package on the same numpy-seeded inputs.

* `_quant_scatter`, both commit rules: codes (compared through uint8
  views: torch.equal has no float8 on the CPU) and scales bit-identical
  to the reference, plus the reference suite's properties (round-trip
  bound, row-commit ignores non-opening rows, exact zero, sentinel
  parking drops everything, re-open erases a stale scale, appends reuse
  the committed scale).
* The three paged wrappers with scales vs the Pallas kernel's quantized
  branch in interpret mode at the paged suite's 2e-5 (the two differ in
  softmax reduction order only), and the -1 table tail bit for bit; the
  split plain version (the bf16 split-context kernel's function) at 1,
  2, 3 and 4 partitions to the same bars and within 1e-6 of the
  unsplit plain version.
* The three paged primitives with kv_quant vs the reference's gather
  form: logits at 2e-5, scales at 2e-5 relative, and the stored codes
  equal.
* quantize_params / dequantize_params / params_bytes bit-identical.
* Engines: int8, fp8 and int8-weight traces token- and trajectory-
  identical to the JAX engine; an aliased block shares its scale and a
  copy-on-write copies the scale bands; the allocator prices blocks by
  the one formula; bad knobs raise ValueError.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu.parallel import paged_attention as jpa
from paddle_tpu.serving import ServingEngine as JaxEngine
from paddle_tpu.serving import quantization as jq
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.parallel import paged_attention as tpa
from paddle_tpu_torch.parallel.kernel_utils import raw_bytes
from paddle_tpu_torch.serving import ServingEngine
from paddle_tpu_torch.serving import quantization as tq
from torch_parity import drive, models, t, trace

torch.set_num_threads(2)

KVQS = ["int8", "fp8"]
_ATOL = _RTOL = 2e-5


def _codes(x):
    """Pool codes as raw bytes, JAX array or torch tensor."""
    if isinstance(x, torch.Tensor):
        return raw_bytes(x).numpy().view(np.uint8)
    return np.asarray(x).view(np.uint8)


def _jpool(codes, kvq):
    return jnp.asarray(codes.astype(np.int8)).astype(J.kv_storage_dtype(kvq))


def _tpool(codes, kvq):
    return torch.from_numpy(codes.astype(np.int8)).to(T.kv_storage_dtype(kvq))


# ---------------------------------------------------------------------
# _quant_scatter: bit identity with the reference, and its properties
# ---------------------------------------------------------------------

NB, BT, H, DH = 4, 8, 3, 16


def _case(name, rng):
    """(stale scale [NB, H], pk, off, vals, commit_from_call) for one
    named property of the reference suite (tests/test_kv_quant.py)."""
    zeros = np.zeros((NB, H), np.float32)
    if name == "fill_call_commit":  # one block filled in one call
        return (zeros, np.full(BT, 2), np.arange(BT),
                5.0 * rng.randn(BT, H, DH), True)
    if name == "row_commit":  # a 50x draft row must not reach the scale
        vals = np.stack([np.ones((H, DH)), np.full((H, DH), 50.0)])
        return zeros, np.zeros(2), np.array([0, 1]), vals, False
    if name == "exact_zero":
        return zeros, np.zeros(4), np.arange(4), np.zeros((4, H, DH)), False
    if name == "parked":  # off 0 included: still dropped
        return (rng.rand(NB, H), np.full(2, NB), np.array([0, 1]),
                rng.randn(2, H, DH), False)
    if name == "reopen_stale":
        return (np.full((NB, H), 99.0), np.zeros(1), np.zeros(1),
                np.ones((1, H, DH)), False)
    if name == "append_clips":  # off 1 into a block committed at 1/qmax
        return (np.full((NB, H), 0.0), np.zeros(1), np.ones(1),
                np.full((1, H, DH), 10.0), False)
    # a mixed call: parked, opening and appending rows over several blocks
    pk = np.array([0, 0, 1, 1, 2, NB, 3, 3])
    off = np.array([0, 3, 2, 5, 0, 0, 0, 1])
    return (rng.rand(NB, H), pk, off, 3.0 * rng.randn(8, H, DH),
            name == "mixed_call_commit")


CASES = ["fill_call_commit", "row_commit", "exact_zero", "parked",
         "reopen_stale", "append_clips", "mixed_row_commit",
         "mixed_call_commit"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("kvq", KVQS)
def test_quant_scatter_bit_identical_to_jax(kvq, name):
    rng = np.random.RandomState(CASES.index(name))
    scale0, pk, off, vals, commit = _case(name, rng)
    qmax = T._KV_QMAX[kvq]
    scale0 = np.asarray(scale0, np.float32)
    if name == "append_clips":
        scale0[0] = 1.0 / qmax
    buf0 = rng.randint(-5, 5, (NB, BT, H, DH))
    pk, off = pk.astype(np.int32), off.astype(np.int32)
    vals = np.asarray(vals, np.float32)
    jb, js = J._quant_scatter(_jpool(buf0, kvq), jnp.asarray(scale0),
                              jnp.asarray(pk), jnp.asarray(off),
                              jnp.asarray(vals), qmax,
                              commit_from_call=commit)
    tb, ts = _tpool(buf0, kvq), t(scale0.copy())
    out_b, out_s = T._quant_scatter(tb, ts, t(pk), t(off), t(vals), qmax,
                                    commit_from_call=commit)
    assert out_b is tb and out_s is ts  # in place
    np.testing.assert_array_equal(_codes(tb), _codes(jb))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    deq = tb.float().numpy() * ts.numpy()[:, None, :, None]
    if name == "fill_call_commit":
        amax = np.abs(vals).max(axis=(0, 2))
        np.testing.assert_allclose(ts.numpy()[2], amax / qmax, rtol=1e-6)
        bound = ((ts.numpy()[2] / 2 + 1e-7)[None, :, None] if kvq == "int8"
                 else np.abs(vals) / 16.0
                 + (ts.numpy()[2] * 2.0 ** -9)[None, :, None] + 1e-7)
        assert (np.abs(deq[2] - vals) <= bound).all()
    elif name == "row_commit":
        np.testing.assert_allclose(ts.numpy()[0], 1.0 / qmax, rtol=1e-6)
    elif name == "exact_zero":
        assert (deq[0, :4] == 0.0).all() and (ts.numpy()[0] == 0).all()
    elif name == "parked":
        np.testing.assert_array_equal(_codes(tb), _codes(_tpool(buf0, kvq)))
        np.testing.assert_array_equal(ts.numpy(), scale0)
    elif name == "reopen_stale":
        np.testing.assert_allclose(ts.numpy()[0], 1.0 / qmax, rtol=1e-6)
        np.testing.assert_allclose(ts.numpy()[1:], 99.0)
    elif name == "append_clips":
        np.testing.assert_array_equal(ts.numpy(), scale0)
        np.testing.assert_allclose(deq[0, 1], 1.0, rtol=1e-5)


# ---------------------------------------------------------------------
# the wrappers with scales vs the Pallas kernel's quantized branch
# ---------------------------------------------------------------------

PNB, PBT, PH, PDH = 10, 8, 4, 8


def _qpool(seed, kvq):
    """Random codes AND scales: clamped -1 entries surface finite
    nonzero garbage the position mask must erase exactly."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(-100, 100, (PNB, PBT, PH, PDH))
    ks = rng.rand(PNB, PH).astype(np.float32)
    vs = rng.rand(PNB, PH).astype(np.float32)
    return codes, -codes, ks, vs


_WINDOWS = {
    "decode": (np.array([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]]),
               np.array([9, 20, 3]), (3, PH, PDH)),
    "verify": (np.array([[0, 1, 2, -1], [3, 4, -1, -1]]),
               np.array([17, 9]), (2, 3, PH, PDH)),
    "prefill": (np.array([6, 1, 2, -1]), 10, (8, PH, PDH)),
}


@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("kvq", KVQS)
def test_wrappers_with_scales_match_jax_kernel(kvq, which):
    kc, vc, ks, vs = _qpool(0, kvq)
    tables, base, qshape = _WINDOWS[which]
    tables = tables.astype(np.int32)
    q = np.random.RandomState(1).randn(*qshape).astype(np.float32)
    jfn = getattr(jpa, "paged_%s_attention" % which)
    tfn = getattr(tpa, "paged_%s_attention" % which)
    jbase = base if which == "prefill" else jnp.asarray(base, jnp.int32)
    tbase = base if which == "prefill" else t(base.astype(np.int32))
    want = jfn(jnp.asarray(q), _jpool(kc, kvq), _jpool(vc, kvq),
               jnp.asarray(tables), jbase, interpret=True,
               k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = tfn(t(q), _tpool(kc, kvq), _tpool(vc, kvq), t(tables), tbase,
              k_scale=t(ks), v_scale=t(vs))
    assert got.dtype == torch.float32 and got.shape == qshape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL,
                               atol=_ATOL)


@pytest.mark.parametrize("kvq", KVQS)
def test_quant_garbage_rows_bit_identical(kvq):
    """A -1 table tail over a quantized pool gives output bit-identical
    to a full table at the same positions, decode and verify."""
    kc, vc, ks, vs = _qpool(2, kvq)
    k, v = _tpool(kc, kvq), _tpool(vc, kvq)
    sc = dict(k_scale=t(ks), v_scale=t(vs))
    partial = t(np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32))
    full = t(np.array([[0, 1, 8, 9], [2, 7, 5, 3]], np.int32))
    pos = t(np.array([9, 5], np.int32))
    rng = np.random.RandomState(3)
    q = t(rng.randn(2, PH, PDH).astype(np.float32))
    assert torch.equal(tpa.paged_decode_attention(q, k, v, partial, pos, **sc),
                       tpa.paged_decode_attention(q, k, v, full, pos, **sc))
    qw = t(rng.randn(2, 2, PH, PDH).astype(np.float32))
    assert torch.equal(tpa.paged_verify_attention(qw, k, v, partial, pos, **sc),
                       tpa.paged_verify_attention(qw, k, v, full, pos, **sc))


# ---------------------------------------------------------------------
# the split plain version (the bf16 split-context kernel's computation)
# over quantized pools: vs the unsplit plain version at atol/rtol 1e-6
# (outputs reach ~40 here, where one f32 ulp is ~4e-6) and the
# Pallas kernel's quantized branch at 2e-5, -1 tails bit for bit
# ---------------------------------------------------------------------

SPLIT_PARTS = [1, 2, 3, 4]  # up to MAXB, the tables' 4 entries


def _split_window(kvq, which):
    """(q [S, R, H, Dh], pools, scales, tables, base) of a window."""
    kc, vc, ks, vs = _qpool(0, kvq)
    tables, base, qshape = _WINDOWS[which]
    q = np.random.RandomState(1).randn(*qshape).astype(np.float32)
    if which == "decode":
        q = q[:, None]
    elif which == "prefill":
        q, tables, base = q[None], tables[None], np.array([base])
    return (t(q), _tpool(kc, kvq), _tpool(vc, kvq), t(ks), t(vs),
            t(tables.astype(np.int32)), t(base.astype(np.int32)))


@functools.lru_cache(maxsize=None)
def _jax_quant_window(kvq, which):
    """The Pallas kernel's quantized branch (interpret mode) on a window,
    as [S, R, H, Dh]."""
    kc, vc, ks, vs = _qpool(0, kvq)
    tables, base, qshape = _WINDOWS[which]
    q = np.random.RandomState(1).randn(*qshape).astype(np.float32)
    jbase = base if which == "prefill" else jnp.asarray(base, jnp.int32)
    out = np.asarray(getattr(jpa, "paged_%s_attention" % which)(
        jnp.asarray(q), _jpool(kc, kvq), _jpool(vc, kvq),
        jnp.asarray(tables.astype(np.int32)), jbase, interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs)))
    return out[:, None] if which == "decode" else (
        out[None] if which == "prefill" else out)


@pytest.mark.parametrize("parts", SPLIT_PARTS)
@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("kvq", KVQS)
def test_split_plain_with_scales_matches_plain_and_jax(kvq, which, parts):
    q, k, v, ks, vs, tables, base = _split_window(kvq, which)
    kw = dict(scale=1.0 / np.sqrt(PDH), scale_in_q=which != "decode",
              k_scale=ks, v_scale=vs)
    split = tpa.paged_attention_split_plain(q, k, v, tables, base,
                                            parts=parts, **kw)
    plain = tpa.paged_attention_plain(q, k, v, tables, base, **kw)
    assert split.dtype == torch.float32 and split.shape == q.shape
    torch.testing.assert_close(split, plain, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(split.numpy(), _jax_quant_window(kvq, which),
                               rtol=_RTOL, atol=_ATOL)


@pytest.mark.parametrize("parts", SPLIT_PARTS)
@pytest.mark.parametrize("kvq", KVQS)
def test_split_plain_quant_garbage_rows_bit_identical(kvq, parts):
    """At a fixed partition count, a -1 tail over a quantized pool gives
    output bit-identical to a full table (decode and verify windows)."""
    kc, vc, ks, vs = _qpool(2, kvq)
    k, v = _tpool(kc, kvq), _tpool(vc, kvq)
    partial = t(np.array([[0, 1, -1, -1], [2, -1, -1, -1]], np.int32))
    full = t(np.array([[0, 1, 8, 9], [2, 7, 5, 3]], np.int32))
    pos = t(np.array([9, 5], np.int32))
    rng = np.random.RandomState(3)
    for R, scale_in_q in ((1, False), (2, True)):
        q = t(rng.randn(2, R, PH, PDH).astype(np.float32))
        a, b = (tpa.paged_attention_split_plain(
            q, k, v, tbl, pos, scale=0.35, scale_in_q=scale_in_q,
            parts=parts, k_scale=t(ks), v_scale=t(vs))
            for tbl in (partial, full))
        assert torch.equal(a, b)


# ---------------------------------------------------------------------
# the paged primitives with kv_quant vs the reference's gather form
# ---------------------------------------------------------------------


def _rand_qcache(cfg, nb, bt, kvq, seed):
    rng = np.random.RandomState(seed)
    dh = cfg.dim // cfg.heads
    out = []
    for _ in range(cfg.layers):
        codes = rng.randint(-100, 100, (nb, bt, cfg.heads, dh))
        out.append((codes, -codes, rng.rand(nb, cfg.heads).astype(np.float32),
                    rng.rand(nb, cfg.heads).astype(np.float32)))
    jc = [{"k": _jpool(kc, kvq), "v": _jpool(vc, kvq),
           "k_scale": jnp.asarray(ks), "v_scale": jnp.asarray(vs)}
          for kc, vc, ks, vs in out]
    tc = [{"k": _tpool(kc, kvq), "v": _tpool(vc, kvq),
           "k_scale": t(ks.copy()), "v_scale": t(vs.copy())}
          for kc, vc, ks, vs in out]
    return jc, tc


def _run_primitive(mod, which, params, cfg, cache, tables, kernel, kvq):
    """One primitive call on a fixed window of the three shapes."""
    conv = jnp.asarray if mod is J else t
    kw = dict(kernel=kernel, kv_quant=kvq)
    if which == "decode":
        return mod.paged_decode_step(
            params, conv(np.array([13, 21, 4], np.int32)),
            conv(np.array([9, 5, 40], np.int32)), conv(tables), cache, cfg,
            **kw)
    if which == "verify":
        window = np.array([[3, 9, 1], [7, 2, 2], [5, 5, 8]], np.int32)
        pos = np.array([8, 15, 30], np.int32)
        wpos = pos[:, None] + np.arange(3)[None]
        wpos[2, 2] = tables.shape[1] * 8  # a past-budget row parks
        return mod.paged_verify_step(params, cache, conv(window), conv(pos),
                                     conv(wpos.astype(np.int32)),
                                     conv(tables), cfg, **kw)
    chunk = np.random.RandomState(4).randint(0, 50, 8).astype(np.int32)
    start = 8
    if mod is J:
        return J.paged_prefill_chunk(params, cache, jnp.asarray(chunk),
                                     jnp.int32(start),
                                     jnp.asarray(tables[0]), cfg,
                                     true_len=jnp.int32(6), **kw)
    return T.paged_prefill_chunk(params, cache, t(chunk), start,
                                 t(tables[0]), cfg, true_len=6, **kw)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
@pytest.mark.parametrize("which", ["decode", "verify", "prefill"])
@pytest.mark.parametrize("kvq", KVQS)
def test_primitives_match_jax_gather(kvq, which, kernel):
    """Logits at 2e-5; after the step the scales agree at 2e-5 relative
    and the codes are equal (the layer-0 rows the step writes come from
    the same weights; later layers inherit attention drift at float
    tolerance, which moves no code at these seeds)."""
    jcfg, jp, cfg, tp = models(11)
    tables = np.array([[0, 1, 2, -1, -1, -1, -1, -1],
                       [3, 4, -1, -1, -1, -1, -1, -1],
                       [5, 6, 7, 8, 9, 10, -1, -1]], np.int32)
    jc, tc = _rand_qcache(cfg, 12, 8, kvq, seed=12)
    jl, jc = _run_primitive(J, which, jp, jcfg, jc, tables, "gather", kvq)
    tl, tc = _run_primitive(T, which, tp, cfg, tc, tables, kernel, kvq)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=_ATOL,
                               rtol=_RTOL)
    for a, b in zip(tc, jc):
        for band in ("k_scale", "v_scale"):
            np.testing.assert_allclose(a[band].numpy(), np.asarray(b[band]),
                                       rtol=_RTOL, atol=0)
        for band in ("k", "v"):
            np.testing.assert_array_equal(_codes(a[band]), _codes(b[band]))


# ---------------------------------------------------------------------
# weight quantization
# ---------------------------------------------------------------------


def test_quantize_params_bit_identical_to_jax():
    rng = np.random.RandomState(0)
    tree = {"w": (3.0 * rng.randn(8, 16)).astype(np.float32),
            "b": rng.randn(16).astype(np.float32),
            "z": np.zeros((4, 4), np.float32),
            "blocks": [{"w1": rng.randn(5, 7).astype(np.float32)}]}
    jt = jq.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tt = tq.quantize_params(T.params_from_numpy(tree, device="cpu"))
    for jl, tl in ((jt["w"], tt["w"]), (jt["z"], tt["z"]),
                   (jt["blocks"][0]["w1"], tt["blocks"][0]["w1"])):
        assert isinstance(tl, tq.QuantTensor) and tl.codes.dtype == torch.int8
        np.testing.assert_array_equal(tl.codes.numpy(), np.asarray(jl.codes))
        assert float(tl.scale) == float(jl.scale)
        assert tl.shape == tuple(jl.shape) and tl.nbytes == jl.nbytes
    assert not isinstance(tt["b"], tq.QuantTensor)
    jd, td = jq.dequantize_params(jt), tq.dequantize_params(tt)
    for key in ("w", "b", "z"):
        np.testing.assert_array_equal(td[key].numpy(), np.asarray(jd[key]))
    assert (td["z"] == 0).all()
    bound = np.abs(tree["w"]).max() / 127.0 / 2 + 1e-6
    assert (np.abs(td["w"].numpy() - tree["w"]) <= bound).all()
    assert tq.params_bytes(tt) == jq.params_bytes(jt) < tq.params_bytes(
        td)


# ---------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------

ENGINE = dict(max_slots=3, kv_block_tokens=8, prefill_chunk_tokens=8,
              prefix_cache_tokens=64, kv_pool_blocks=13,
              max_prefills_per_step=2)


@pytest.mark.parametrize("knobs", [
    {"kv_quant": "int8"}, {"kv_quant": "fp8"}, {"weight_quant": "int8"},
], ids=["int8", "fp8", "weight_int8"])
def test_engine_matches_jax_engine(knobs):
    """The same trace through the JAX engine (gather form) and the port:
    tokens and finish reasons per request, the per-step trajectory, the
    prefix hits, copy-on-writes and block bytes all equal."""
    jcfg, jp, cfg, tp = models(0)
    reqs = trace(0)
    cow_prompt = np.random.RandomState(1).randint(0, 50, 24).astype(np.int32)
    jeng = JaxEngine(jp, jcfg, paged_kernel="gather", **ENGINE, **knobs)
    teng = ServingEngine(tp, cfg, device="cpu", **ENGINE, **knobs)
    jout, jtraj = drive(jeng, reqs, cow_prompt)
    tout, ttraj = drive(teng, reqs, cow_prompt)
    assert tout == jout
    assert ttraj == jtraj
    assert any(q and live + pre < ENGINE["max_slots"]
               for q, live, pre, _ in ttraj)  # backpressure happened
    jrep, trep = jeng.metrics.report(), teng.metrics.report()
    assert trep["prefix_cache"]["hits"] == jrep["prefix_cache"]["hits"] >= 2
    assert trep["cow_blocks"] == jrep["cow_blocks"] >= 1
    assert teng.kv_block_bytes == jeng.kv_block_bytes
    for key in ("kv_quant", "weight_quant", "prefill_tokens_computed",
                "kv_blocks_in_use"):
        assert trep[key] == jrep[key]
    if "weight_quant" in knobs:
        assert isinstance(teng._params["blocks"][0]["wq"], tq.QuantTensor)
        assert "k_scale" not in teng._cache[0]
    else:
        assert teng._cache[0]["k"].dtype == T.kv_storage_dtype(
            knobs["kv_quant"])


def test_engine_aliased_block_shares_scale_and_cow_copies_it():
    """A published whole-block prompt served again aliases its blocks:
    their scales stay bit-untouched, the copied-on-write block gets the
    payload and scale of its source, and the tokens repeat."""
    _, _, cfg, tp = models(5)
    prompt = np.random.RandomState(5).randint(0, 50, 24).astype(np.int32)
    eng = ServingEngine(tp, cfg, max_slots=2, kv_block_tokens=8,
                        prefix_cache_tokens=256, kv_quant="int8",
                        device="cpu")
    h0 = eng.submit(prompt, 5)
    eng.run()
    m = eng.prefix_cache.match(prompt, record=False)
    src = [int(b) for b in m.payloads]
    m.release()
    assert len(src) == 3
    before = [(kv["k_scale"][src].clone(), kv["v_scale"][src].clone())
              for kv in eng._cache]
    h1 = eng.submit(prompt, 5)
    eng.run()
    assert eng.metrics.cow_blocks == 1
    for kv, (ks, vs) in zip(eng._cache, before):
        assert torch.equal(kv["k_scale"][src], ks)
        assert torch.equal(kv["v_scale"][src], vs)
    assert h1.tokens == h0.tokens
    # the copy itself: every band of every layer, scales included
    rng = np.random.RandomState(6)
    for kv in eng._cache:
        kv["k"][1] = t(rng.randint(-9, 9, kv["k"].shape[1:]).astype(np.int8))
        kv["k_scale"][1] = t(rng.rand(cfg.heads).astype(np.float32))
    eng._cow(3, 1)
    for kv in eng._cache:
        for band in ("k", "v", "k_scale", "v_scale"):
            assert torch.equal(kv[band][3], kv[band][1])


def test_engine_block_bytes_and_knob_refusals():
    _, _, cfg, tp = models(13)
    dh = cfg.dim // cfg.heads
    e8 = ServingEngine(tp, cfg, max_slots=1, kv_block_tokens=8,
                       kv_quant="int8", device="cpu")
    want = 2 * cfg.layers * 8 * cfg.heads * dh + 2 * cfg.layers * cfg.heads * 4
    assert e8.kv_block_bytes == want == J.kv_block_bytes(
        cfg.layers, cfg.heads, dh, 8, "int8")
    h = e8.submit(np.arange(6), 4)
    e8.step()
    st = e8._alloc.stats()
    assert st["block_bytes"] == want
    assert st["bytes_in_use"] == st["blocks_in_use"] * want > 0
    h.result()
    for knob in ({"kv_quant": "int4"}, {"weight_quant": "int4"},
                 {"weight_quant": "fp8"}):
        with pytest.raises(ValueError):
            ServingEngine(tp, cfg, max_slots=1, device="cpu", **knob)
    with pytest.raises(ValueError, match="kv_quant"):
        T.kv_block_bytes(2, 4, 8, 8, "int4")
