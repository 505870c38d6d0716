"""The port's transformer LM (paddle_tpu_torch/models/transformer.py)
against the JAX package on the same weights and inputs.

Weights come from the JAX `init_params` through `params_from_numpy`;
inputs from numpy seeds. Tolerances: the dense forward at 1e-5 (same
math, float32 reduction order only); the paged primitives at the JAX
paged suite's pinned 2e-5 (logits and caches — layer l>0 cache writes
inherit layer l-1's attention drift); greedy generation token for
token; the traps exactly. The training slice: forward(attn_impl=
"flash") at 1e-5 and loss_fn at 1e-6 relative (reduction order);
3 SGD steps at lr 0.5 through the flash path at 1e-5 relative on each
loss and 1e-4 on every final parameter (the drift of 3 steps of f32
reduction order through the large lr).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import transformer as J
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.utils import prng

torch.set_num_threads(2)

_ATOL = 2e-5
_RTOL = 2e-5


def _mk(seed=0, **kw):
    dims = dict(vocab=50, dim=32, heads=4, layers=2, max_len=64)
    dims.update(kw)
    jcfg = J.TransformerConfig(**dims)
    jp = J.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = T.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                             device="cpu")
    return jcfg, jp, T.TransformerConfig(**dims), tp


def _rand_pool(cfg, NB, Bt, seed):
    rng = np.random.RandomState(seed)
    dh = cfg.dim // cfg.heads
    return [{"k": rng.randn(NB, Bt, cfg.heads, dh).astype(np.float32),
             "v": rng.randn(NB, Bt, cfg.heads, dh).astype(np.float32)}
            for _ in range(cfg.layers)]


def _jcache(pool):
    return [{b: jnp.asarray(a) for b, a in kv.items()} for kv in pool]


def _tcache(pool):
    return [{b: torch.from_numpy(a.copy()) for b, a in kv.items()}
            for kv in pool]


def _close(got, want, atol=_ATOL, rtol=_RTOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=rtol)


def _caches_close(tc, jc):
    for a, b in zip(tc, jc):
        for band in ("k", "v"):
            _close(a[band], b[band])


def test_forward_logits_match_jax():
    jcfg, jp, cfg, tp = _mk(0)
    toks = np.random.RandomState(0).randint(0, 50, (2, 13)).astype(np.int32)
    want = J.forward(jp, jnp.asarray(toks), jcfg, attn_impl="reference")
    got = T.forward(tp, torch.from_numpy(toks), cfg)
    _close(got, want, atol=1e-5, rtol=1e-5)
    want = J.forward(jp, jnp.asarray(toks), jcfg, attn_impl="reference",
                     last_only=True)
    _close(T.forward(tp, torch.from_numpy(toks), cfg, last_only=True),
           want, atol=1e-5, rtol=1e-5)


def test_forward_flash_logits_match_jax():
    """forward(attn_impl="flash") through the port's flash path (the
    plain versions on the CPU) vs the JAX forward through the Pallas
    kernel in interpret mode, at T 64."""
    jcfg, jp, cfg, tp = _mk(10)
    toks = np.random.RandomState(10).randint(0, 50, (2, 64)).astype(np.int32)
    want = J.forward(jp, jnp.asarray(toks), jcfg, attn_impl="flash")
    got = T.forward(tp, torch.from_numpy(toks), cfg, attn_impl="flash")
    _close(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("attn_impl", ["flash", "reference"])
def test_loss_fn_matches_jax(attn_impl):
    jcfg, jp, cfg, tp = _mk(11)
    toks = np.random.RandomState(11).randint(0, 50, (2, 65)).astype(np.int32)
    want = J.loss_fn(jp, jnp.asarray(toks), jcfg, attn_impl=attn_impl)
    got = T.loss_fn(tp, torch.from_numpy(toks), cfg, attn_impl=attn_impl)
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_steps_match_jitted_jax():
    """3 SGD steps at lr 0.5 through the flash path: the port's
    _FlashAttention backward (the plain versions of the dK/dV and dQ
    kernels on the CPU) vs jax.jit of the JAX step through the Pallas
    backward. Per-step losses within 1e-5 relative and every final
    parameter within 1e-4 (f32 reduction order through 2 layers and 3
    steps, amplified by the large lr)."""
    jcfg, jp, cfg, tp = _mk(12)
    toks = np.random.RandomState(12).randint(0, 50, (2, 65)).astype(np.int32)
    jstep = jax.jit(J.make_train_step(jcfg, lr=0.5, attn_impl="flash"))
    tstep = T.make_train_step(cfg, lr=0.5, attn_impl="flash")
    tt = torch.from_numpy(toks)
    ref = tp
    for _ in range(3):
        jp, jl = jstep(jp, jnp.asarray(toks))
        tp, tl = tstep(tp, tt)
        assert tp is ref  # updated in place, the same dictionary
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    want = jax.tree_util.tree_leaves(jp)
    got = T._leaves(tp)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_paged_decode_step_matches_jax(kernel):
    jcfg, jp, cfg, tp = _mk(1)
    NB, Bt = 10, 8
    tables = np.array([[0, 1, -1, -1], [2, 3, 4, -1], [5, -1, -1, -1]],
                      np.int32)
    pos = np.array([9, 20, 3], np.int32)
    tok = np.array([7, 11, 42], np.int32)
    pool = _rand_pool(cfg, NB, Bt, 1)
    lj, cj = J.paged_decode_step(jp, jnp.asarray(tok), jnp.asarray(pos),
                                 jnp.asarray(tables), _jcache(pool), jcfg,
                                 kernel="gather")
    lt, ct = T.paged_decode_step(tp, torch.from_numpy(tok),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(tables), _tcache(pool),
                                 cfg, kernel=kernel)
    _close(lt, lj)
    _caches_close(ct, cj)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_paged_prefill_chunk_matches_jax(kernel):
    jcfg, jp, cfg, tp = _mk(2)
    NB, Bt = 10, 8
    table_row = np.array([0, 1, 2, -1], np.int32)
    chunk = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
    pool = _rand_pool(cfg, NB, Bt, 2)
    lj, cj = J.paged_prefill_chunk(jp, _jcache(pool), jnp.asarray(chunk),
                                   jnp.int32(10), jnp.asarray(table_row),
                                   jcfg, true_len=jnp.int32(5),
                                   kernel="gather")
    lt, ct = T.paged_prefill_chunk(tp, _tcache(pool),
                                   torch.from_numpy(chunk), 10,
                                   torch.from_numpy(table_row), cfg,
                                   true_len=5, kernel=kernel)
    _close(lt, lj)
    _caches_close(ct, cj)


@pytest.mark.parametrize("kernel", ["gather", "fused"])
def test_paged_verify_step_matches_jax(kernel):
    jcfg, jp, cfg, tp = _mk(3)
    NB, Bt, K = 10, 8, 3
    tables = np.array([[0, 1, 2, -1], [3, 4, -1, -1]], np.int32)
    pos = np.array([17, 9], np.int32)
    window = np.array([[5, 6, 7], [8, 9, 10]], np.int32)
    # the second slot's last row runs past its budget: parked write
    wpos = pos[:, None] + np.arange(K)[None, :]
    wpos[1, 2] = 4 * Bt
    pool = _rand_pool(cfg, NB, Bt, 3)
    lj, cj = J.paged_verify_step(jp, _jcache(pool), jnp.asarray(window),
                                 jnp.asarray(pos), jnp.asarray(wpos),
                                 jnp.asarray(tables), jcfg, kernel="gather")
    lt, ct = T.paged_verify_step(tp, _tcache(pool),
                                 torch.from_numpy(window),
                                 torch.from_numpy(pos),
                                 torch.from_numpy(wpos),
                                 torch.from_numpy(tables), cfg,
                                 kernel=kernel)
    _close(lt, lj)
    _caches_close(ct, cj)


def test_parked_and_unallocated_writes_leave_pool_untouched():
    """Rows parked past the table span, and rows landing on a -1 entry,
    resolve to block NB and are dropped — the pool is bit-unchanged."""
    _, _, cfg, tp = _mk(4)
    NB, Bt = 6, 8
    pool = _rand_pool(cfg, NB, Bt, 4)
    cache = _tcache(pool)
    tables = torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]], dtype=torch.int32)
    pos = torch.tensor([4 * Bt, 9], dtype=torch.int32)  # parked; -1 entry
    T.paged_decode_step(tp, torch.tensor([1, 2]), pos, tables, cache, cfg,
                        kernel="fused")
    for kv, ref in zip(cache, pool):
        for band in ("k", "v"):
            assert np.array_equal(kv[band].numpy(), ref[band])
    chunk = torch.tensor([1, 2, 3, 4])
    T.paged_prefill_chunk(tp, cache, chunk, 0, tables[0], cfg, true_len=0,
                          kernel="fused")
    for kv, ref in zip(cache, pool):
        assert np.array_equal(kv["k"].numpy(), ref["k"])


def test_garbage_rows_bit_identical_through_decode_step():
    _, _, cfg, tp = _mk(5)
    NB, Bt = 12, 8
    partial = torch.tensor([[0, 1, -1, -1], [2, -1, -1, -1]],
                           dtype=torch.int32)
    full = torch.tensor([[0, 1, 8, 9], [2, 10, 11, 7]], dtype=torch.int32)
    pos = torch.tensor([9, 5], dtype=torch.int32)
    tok = torch.tensor([13, 21])
    for kernel in ("gather", "fused"):
        la, ca = T.paged_decode_step(tp, tok, pos, partial,
                                     _tcache(_rand_pool(cfg, NB, Bt, 5)),
                                     cfg, kernel=kernel)
        lb, cb = T.paged_decode_step(tp, tok, pos, full,
                                     _tcache(_rand_pool(cfg, NB, Bt, 5)),
                                     cfg, kernel=kernel)
        assert torch.equal(la, lb)
        for a, b in zip(ca, cb):
            assert torch.equal(a["k"], b["k"]) and torch.equal(a["v"], b["v"])


def test_greedy_generate_token_identical():
    jcfg, jp, cfg, tp = _mk(6)
    prompt = np.random.RandomState(6).randint(0, 50, (2, 7)).astype(np.int32)
    want = np.asarray(J.generate(jp, jnp.asarray(prompt), jcfg, 12))
    got = T.generate(tp, torch.from_numpy(prompt), cfg, 12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sampled_generate_and_eos_token_identical():
    jcfg, jp, cfg, tp = _mk(7)
    prompt = np.random.RandomState(7).randint(0, 50, (2, 5)).astype(np.int32)
    want = np.asarray(J.generate(jp, jnp.asarray(prompt), jcfg, 10,
                                 temperature=0.9,
                                 key=jax.random.PRNGKey(3)))
    got = T.generate(tp, torch.from_numpy(prompt), cfg, 10,
                     temperature=0.9, key=prng.PRNGKey(3))
    np.testing.assert_array_equal(got.numpy(), want)
    # EOS: pick the greedy continuation's third token as eos, so the
    # freeze and the early exit both happen
    greedy = np.asarray(J.generate(jp, jnp.asarray(prompt), jcfg, 10))
    eos = int(greedy[0, 7])
    want = np.asarray(J.generate(jp, jnp.asarray(prompt), jcfg, 10,
                                 eos_id=eos))
    got = T.generate(tp, torch.from_numpy(prompt), cfg, 10, eos_id=eos)
    np.testing.assert_array_equal(got.numpy(), want)


def test_traps_match_jax():
    rng = np.random.RandomState(8)
    lg = rng.randn(4, 50).astype(np.float32)
    lg[1, 3] = np.nan
    lg[2, :] = -np.inf
    mask = np.array([True, True, False, True])
    np.testing.assert_array_equal(
        T.logits_trap(torch.from_numpy(lg)).numpy(),
        np.asarray(J.logits_trap(jnp.asarray(lg))))
    clean = lg[[0, 3]]
    assert float(T.logit_amax(torch.from_numpy(clean))) == float(
        J.logit_amax(jnp.asarray(clean)))
    m = torch.from_numpy(mask[[0, 1]])
    assert float(T.logit_amax(torch.from_numpy(lg[[0, 3]]), m)) == float(
        J.logit_amax(jnp.asarray(lg[[0, 3]]), jnp.asarray(mask[[0, 1]])))


def test_block_bytes_and_init_params_law():
    jcfg, _, cfg, _ = _mk(9)
    assert T.kv_block_bytes(8, 8, 64, 16, act_itemsize=2) == \
        J.kv_block_bytes(8, 8, 64, 16, act_itemsize=2) == 256 * 1024
    p = T.init_params(T.TransformerConfig(vocab=300, dim=64, heads=4,
                                          layers=1, max_len=32),
                      torch.Generator().manual_seed(0), device="cpu")
    assert p["embed"].shape == (300, 64) and p["blocks"][0]["w1"].shape \
        == (64, 256)
    std = float(p["embed"].std())
    assert abs(std - 1.0 / 8.0) < 0.01  # N(0, 1) / sqrt(dim)
    assert torch.equal(p["ln_f"]["g"], torch.ones(64))


def test_entry_points_refuse_missing_cuda_and_unported_branches():
    cfg = T.TransformerConfig(vocab=50, dim=32, heads=4, layers=1)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_params(cfg, torch.Generator())
        with pytest.raises(RuntimeError, match="device='cpu'"):
            T.init_paged_kv_cache(cfg, 4, 8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.TransformerConfig(moe_experts=4)
    with pytest.raises(ValueError, match="kv_quant"):
        T.init_paged_kv_cache(cfg, 4, 8, kv_quant="int4", device="cpu")
    p = T.init_params(cfg, torch.Generator(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.forward(p, torch.zeros(1, 8, dtype=torch.long), cfg,
                  mesh=object(), attn_impl="flash")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.make_train_step(cfg, mesh=object())(
            p, torch.zeros(1, 9, dtype=torch.long))
    with pytest.raises(ValueError):
        T.paged_decode_step(p, torch.tensor([1]), torch.tensor([0]),
                            torch.tensor([[0]]),
                            T.init_paged_kv_cache(cfg, 2, 8, device="cpu"),
                            cfg, kernel="mosaic")
