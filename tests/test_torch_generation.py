"""The port's slotted chunked prefill, beam search and MoE decode paths
(paddle_tpu_torch/models/transformer.py) against the JAX package on the
same weights (JAX `init_params` through `params_from_numpy`) and inputs.

- `prefill_chunk`: logits and cache against the JAX one at 2e-5 (the
  paged suite's bar), and a prompt run chunk by chunk (the last chunk
  padded) bit-equal to the monolithic `prefill` in f32;
- `beam_search_generate`: tokens equal, scores at 1e-5 and
  `LAST_DECODE_STATS` equal to the JAX package's, beam 1 equal to
  greedy, eos freezing and the early exit (the JAX suite's cases in
  tests/test_generation_kv_cache.py);
- greedy `generate` with MoE blocks token for token (and its eos stats);
  MoE blocks through the three paged primitives at 2e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu_torch.models import transformer as T

torch.set_num_threads(2)

_ATOL = _RTOL = 2e-5


def _mk(seed=0, **kw):
    dims = dict(vocab=50, dim=32, heads=4, layers=2, max_len=32)
    dims.update(kw)
    jcfg = J.TransformerConfig(**dims)
    jp = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, T.TransformerConfig(**dims), tp


def _close(got, want, atol=_ATOL, rtol=_RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _eos_biased(seed, scale, **kw):
    """A model whose eos row of the tied embedding is inflated, so eos
    becomes the likely next token (the JAX suite's trick)."""
    jcfg, jp, cfg, _ = _mk(seed, **kw)
    eos = jcfg.vocab - 1
    jp["embed"] = jp["embed"].at[eos].mul(scale)
    tp = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, cfg, tp


# --- prefill_chunk -----------------------------------------------------


@pytest.mark.parametrize("start,C,true_len", [(0, 8, 8), (10, 8, 5),
                                              (3, 4, 4)])
def test_prefill_chunk_matches_jax(start, C, true_len):
    jcfg, jp, cfg, tp = _mk(1)
    S, dh = 3, cfg.dim // cfg.heads
    rng = np.random.RandomState(start)
    pool = [{b: rng.randn(S, cfg.max_len, cfg.heads, dh).astype(np.float32)
             for b in ("k", "v")} for _ in range(cfg.layers)]
    chunk = rng.randint(0, cfg.vocab, (C,)).astype(np.int32)
    lj, cj = J.prefill_chunk(
        jp, [{b: jnp.asarray(a) for b, a in kv.items()} for kv in pool],
        jnp.asarray(chunk), start, 1, jcfg, true_len=true_len)
    cache = [{b: torch.from_numpy(a.copy()) for b, a in kv.items()}
             for kv in pool]
    lt, ct = T.prefill_chunk(tp, cache, torch.from_numpy(chunk), start, 1,
                             cfg, true_len=true_len)
    assert ct is cache  # updated in place
    _close(lt, lj)
    for a, b in zip(ct, cj):
        for band in ("k", "v"):
            _close(a[band], b[band])
    # padded rows parked at L: the slot past the real rows is untouched
    for a, ref in zip(ct, pool):
        assert np.array_equal(a["k"][1, start + true_len:].numpy(),
                              ref["k"][1, start + true_len:])
        assert np.array_equal(a["k"][0].numpy(), ref["k"][0])


@pytest.mark.parametrize("moe", [0, 4])
def test_chunked_prefill_is_bit_equal_to_monolithic(moe):
    _, _, cfg, tp = _mk(2, moe_experts=moe)
    prompt = torch.from_numpy(
        np.random.RandomState(2).randint(0, cfg.vocab, (1, 21)))
    logits, mono = T.prefill(tp, prompt, cfg)
    cache = T.init_kv_cache(cfg, 2, device="cpu")
    C = 8
    for s0 in range(0, 21, C):
        part = prompt[0, s0:s0 + C]
        n = part.shape[0]
        chunk = torch.cat([part, part.new_zeros(C - n)])  # pad to C
        lc, cache = T.prefill_chunk(tp, cache, chunk, s0, 1, cfg,
                                    true_len=n)
    assert torch.equal(lc, logits[0])
    for a, b in zip(cache, mono):
        for band in ("k", "v"):
            assert torch.equal(a[band][1], b[band][0])
            assert not a[band][0].any()  # the other slot stays zero


# --- beam search -------------------------------------------------------


def _beam_pair(jcfg, jp, cfg, tp, prompt, **kw):
    bj, sj = J.beam_search_generate(jp, jnp.asarray(prompt), jcfg, **kw)
    jstats = dict(J.LAST_DECODE_STATS)
    bt, st = T.beam_search_generate(tp, torch.from_numpy(prompt), cfg, **kw)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5,
                               rtol=1e-5)
    for k in ("steps_executed", "max_steps"):
        assert T.LAST_DECODE_STATS[k] == jstats[k]
    return bt, st


@pytest.mark.parametrize("vocab,W,new,alpha", [(50, 4, 5, 0.0),
                                               (12, 5, 1, 0.0),
                                               (12, 3, 6, 0.6)])
def test_beam_search_matches_jax(vocab, W, new, alpha):
    jcfg, jp, cfg, tp = _mk(9, vocab=vocab)
    prompt = np.random.RandomState(9).randint(0, vocab, (3, 4)).astype(
        np.int32)
    _, st = _beam_pair(jcfg, jp, cfg, tp, prompt, max_new_tokens=new,
                       beam_size=W, alpha=alpha)
    assert (np.diff(st.numpy(), axis=1) <= 1e-5).all()  # best first


def test_beam_size_one_is_greedy():
    jcfg, jp, cfg, tp = _mk(7)
    prompt = np.random.RandomState(7).randint(0, 50, (2, 4)).astype(np.int32)
    bt, _ = _beam_pair(jcfg, jp, cfg, tp, prompt, max_new_tokens=6,
                       beam_size=1)
    greedy = T.generate(tp, torch.from_numpy(prompt), cfg, 6)
    assert torch.equal(bt[:, 0], greedy)


def test_beam_search_eos_freezes_like_jax():
    jcfg, jp, cfg, tp = _eos_biased(11, 20.0, vocab=8)
    prompt = np.random.RandomState(11).randint(0, 7, (1, 3)).astype(np.int32)
    bt, st = _beam_pair(jcfg, jp, cfg, tp, prompt, max_new_tokens=6,
                        beam_size=3)
    eos = cfg.vocab - 1
    for row in bt[0, :, 3:].numpy():
        hits = np.nonzero(row == eos)[0]
        if hits.size:  # once finished, only eos follows
            assert (row[hits[0]:] == eos).all()
    assert torch.isfinite(st).all()


def test_beam_search_early_exit_like_jax():
    jcfg, jp, cfg, tp = _eos_biased(21, 50.0, vocab=8)
    prompt = np.random.RandomState(21).randint(0, 7, (2, 3)).astype(np.int32)
    _beam_pair(jcfg, jp, cfg, tp, prompt, max_new_tokens=24, beam_size=3)
    assert T.LAST_DECODE_STATS["max_steps"] == 23
    assert T.LAST_DECODE_STATS["steps_executed"] < 8


def test_beam_search_errors():
    _, _, cfg, tp = _mk(3)
    prompt = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="max_new_tokens"):
        T.beam_search_generate(tp, prompt, cfg, max_new_tokens=0)
    with pytest.raises(ValueError, match="max_len"):
        T.beam_search_generate(tp, prompt, cfg, max_new_tokens=cfg.max_len)


# --- MoE decode paths --------------------------------------------------


@pytest.mark.parametrize("eos", [False, True])
def test_greedy_generate_with_moe_blocks_matches_jax(eos):
    kw = dict(moe_experts=4)
    if eos:
        jcfg, jp, cfg, tp = _eos_biased(31, 50.0, vocab=8, **kw)
    else:
        jcfg, jp, cfg, tp = _mk(31, **kw)
    eos_id = cfg.vocab - 1 if eos else None
    prompt = np.random.RandomState(31).randint(0, cfg.vocab - 1,
                                               (3, 4)).astype(np.int32)
    want = J.generate(jp, jnp.asarray(prompt), jcfg, 12, eos_id=eos_id)
    jstats = dict(J.LAST_DECODE_STATS)
    got = T.generate(tp, torch.from_numpy(prompt), cfg, 12, eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if eos:
        for k in ("greedy_steps_executed", "greedy_max_steps"):
            assert T.LAST_DECODE_STATS[k] == jstats[k]


def _pool(cfg, NB, Bt, seed):
    rng = np.random.RandomState(seed)
    dh = cfg.dim // cfg.heads
    return [{b: rng.randn(NB, Bt, cfg.heads, dh).astype(np.float32)
             for b in ("k", "v")} for _ in range(cfg.layers)]


def _caches(pool):
    return ([{b: jnp.asarray(a) for b, a in kv.items()} for kv in pool],
            [{b: torch.from_numpy(a.copy()) for b, a in kv.items()}
             for kv in pool])


@pytest.mark.parametrize("kernel", ["gather", "fused"])
@pytest.mark.parametrize("which", ["decode", "prefill", "verify"])
def test_paged_primitives_with_moe_blocks_match_jax(which, kernel):
    jcfg, jp, cfg, tp = _mk(5, moe_experts=4, max_len=64)
    NB, Bt = 10, 8
    jc, tc = _caches(_pool(cfg, NB, Bt, 5))
    t = torch.from_numpy
    if which == "decode":
        tables = np.array([[0, 1, -1, -1], [2, 3, 4, -1]], np.int32)
        pos, tok = np.array([9, 20], np.int32), np.array([7, 42], np.int32)
        lj, cj = J.paged_decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                     jnp.asarray(tables), jc, jcfg,
                                     kernel="gather")
        lt, ct = T.paged_decode_step(tp, t(tok), t(pos), t(tables), tc, cfg,
                                     kernel=kernel)
    elif which == "prefill":
        row = np.array([0, 1, 2, -1], np.int32)
        chunk = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
        lj, cj = J.paged_prefill_chunk(jp, jc, jnp.asarray(chunk),
                                       jnp.int32(10), jnp.asarray(row),
                                       jcfg, true_len=jnp.int32(5),
                                       kernel="gather")
        lt, ct = T.paged_prefill_chunk(tp, tc, t(chunk), 10, t(row), cfg,
                                       true_len=5, kernel=kernel)
    else:
        tables = np.array([[0, 1, 2, -1], [3, 4, -1, -1]], np.int32)
        pos = np.array([17, 9], np.int32)
        window = np.array([[5, 6, 7], [8, 9, 10]], np.int32)
        wpos = pos[:, None] + np.arange(3)[None, :]
        lj, cj = J.paged_verify_step(jp, jc, jnp.asarray(window),
                                     jnp.asarray(pos), jnp.asarray(wpos),
                                     jnp.asarray(tables), jcfg,
                                     kernel="gather")
        lt, ct = T.paged_verify_step(tp, tc, t(window), t(pos), t(wpos),
                                     t(tables), cfg, kernel=kernel)
    _close(lt, lj)
    for a, b in zip(ct, cj):
        for band in ("k", "v"):
            _close(a[band], b[band])
