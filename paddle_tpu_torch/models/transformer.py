"""Decoder-only transformer LM (counterpart of
paddle_tpu/models/transformer.py): the dense forward pass, the training
loss and SGD step (`loss_fn`, `make_train_step`; attn_impl="flash"
trains through the flash-attention kernels), cached decode and
generation, and the paged-KV serving primitives the serving engine
drives.

Parameters are a plain dictionary of tensors with the JAX package's
pytree layout — {"embed", "pos", "blocks": [{"ln1", "wq", "wk", "wv",
"wo", "ln2", "w1", "w2"}], "ln_f"} — so `params_from_numpy` carries a
JAX checkpoint (converted to numpy by the caller) over unchanged and
the tests compare like with like.

Numerics kept from the reference: LayerNorm with eps 1e-5 and biased
variance, tanh-approximated GELU (jax.nn.gelu's default), a
weight-tied output head, and two attention scaling families — cached
decode scales the scores AFTER QK^T (`_cached_attention`), while the
chunked prefill and verify paths fold the scale into q first and mask
with the finite NEG_INF fill (`reference_attention`'s family).

Differences from JAX that the port makes explicit:
  * the cache primitives UPDATE THE CACHE IN PLACE and return it (JAX
    returns a new pytree and donates the old one);
  * JAX drops out-of-range scatter writes and clamps out-of-range
    gathers silently. Here parked rows (dead decode slots, padded chunk
    rows, past-budget verify rows — all resolved to block NB by
    `_phys_rows`) are dropped by `_RowWriter` without reading anything
    back to the host, and gathers of the positional table clamp their
    index explicitly. The pool is never grown by a sentinel block, so
    `kv_block_bytes` stays the pool's true cost;
  * `make_train_step`'s step updates the parameter tensors IN PLACE
    (JAX returns a new pytree).

Quantized KV pools (kv_quant="int8" | "fp8") store codes with
per-(physical block, head) f32 scales; fp8 codes are gathered and
scattered through a uint8 view of the pool.

The paged primitives take the reference's LoRA adapter pool
(`adapters`, `adapter_idx`: per-slot q/v deltas, `_adapter_qv`).
`decode_window_retire` is the decode window's in-loop retirement rule
and `paged_block_fingerprint` the KV block checksum of the serving
integrity layer. The MoE and mesh (sequence-parallel) branches of the
reference are not ported yet and raise NotImplementedError when asked
for.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel.attention import sequence_parallel_attention
from ..parallel.kernel_utils import NEG_INF, raw_bytes
from ..parallel.paged_attention import paged_view
from ..utils import prng

__all__ = ["TransformerConfig", "init_params", "params_from_numpy",
           "forward", "loss_fn", "make_train_step", "init_kv_cache",
           "decode_step", "prefill",
           "generate", "init_paged_kv_cache", "kv_block_bytes",
           "kv_storage_dtype",
           "paged_decode_step", "paged_prefill_chunk",
           "paged_verify_step", "logits_trap", "logit_amax",
           "decode_window_retire", "paged_block_fingerprint"]


def _not_ported(what: str, item: str):
    raise NotImplementedError("%s is not ported yet — ROADMAP: %s"
                              % (what, item))


class TransformerConfig:
    def __init__(self, vocab=256, dim=128, heads=4, layers=2, mlp_mult=4,
                 max_len=1024, dtype=torch.float32, moe_experts=0):
        if moe_experts:
            _not_ported("the Switch-MoE FFN (moe_experts > 0)",
                        "the parallel slice (expert-parallel MoE)")
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.layers = layers
        self.mlp_mult = mlp_mult
        self.max_len = max_len
        self.dtype = dtype


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and law (dense
    weights N(0, 1) / sqrt(dim), LayerNorm gains 1 and biases 0), drawn
    from `generator` on its own device and placed on `device` (CUDA by
    default). The numbers differ from the JAX init of the same seed;
    use `params_from_numpy` to carry JAX weights over."""
    dev = resolve_device(device)
    d = cfg.dim
    scale = 1.0 / math.sqrt(d)

    def dense(*shape):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (scale * w).to(device=dev, dtype=cfg.dtype)

    def ln():
        return {"g": torch.ones(d, device=dev, dtype=cfg.dtype),
                "b": torch.zeros(d, device=dev, dtype=cfg.dtype)}

    params = {"embed": dense(cfg.vocab, d), "pos": dense(cfg.max_len, d),
              "blocks": [], "ln_f": ln()}
    for _ in range(cfg.layers):
        params["blocks"].append({
            "ln1": ln(), "wq": dense(d, d), "wk": dense(d, d),
            "wv": dense(d, d), "wo": dense(d, d), "ln2": ln(),
            "w1": dense(d, cfg.mlp_mult * d),
            "w2": dense(cfg.mlp_mult * d, d),
        })
    return params


def params_from_numpy(tree, device=None, dtype=None):
    """Carry a parameter pytree of numpy arrays (a JAX checkpoint after
    `jax.tree_util.tree_map(np.asarray, params)`) into the port's
    parameters: the same nesting of dicts and lists, each leaf a tensor
    on `device` (CUDA by default), cast to `dtype` when given."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":  # ml_dtypes: no torch view
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a))  # a writable copy
        return t.to(device=dev, dtype=dtype or t.dtype)

    return conv(tree)


def _ln(x, p):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-5) * p["g"] + p["b"]


def _mlp(x, blk):
    h = _ln(x, blk["ln2"])
    return x + F.gelu(h @ blk["w1"], approximate="tanh") @ blk["w2"]


def _pos_rows(params, positions):
    """Positional-table rows for an int or an index tensor, the index
    clamped to the table as JAX's gather clamps it (parked rows carry
    out-of-range positions)."""
    table = params["pos"]
    if isinstance(positions, int):
        return table[min(max(positions, 0), table.shape[0] - 1)]
    return table[positions.long().clamp(0, table.shape[0] - 1)]


def forward(params, tokens, cfg: TransformerConfig, mesh=None,
            attn_impl: str = "ring", kv_sink=None, last_only=False,
            last_index=None):
    """tokens [B, T] int -> logits [B, T, vocab] (or [B, vocab] of the
    final position with `last_only`, or of position `last_index`). With
    `kv_sink` (a list), each block appends its (k, v) [B, T, H, Dh].
    Attention goes through `sequence_parallel_attention`: without a
    mesh, attn_impl="flash" runs the flash kernels and every other impl
    the plain causal attention, as in the reference."""
    if mesh is not None:
        _not_ported("mesh (sequence-parallel) attention",
                    "the parallel slice")
    B, T = tokens.shape
    H, dh = cfg.heads, cfg.dim // cfg.heads
    x = params["embed"][tokens.long()] + params["pos"][:T][None]
    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"]).reshape(B, T, H, dh)
        k = (h @ blk["wk"]).reshape(B, T, H, dh)
        v = (h @ blk["wv"]).reshape(B, T, H, dh)
        if kv_sink is not None:
            kv_sink.append((k, v))
        o = sequence_parallel_attention(q, k, v, mesh=mesh, axis="seq",
                                        impl=attn_impl, causal=True)
        x = x + o.reshape(B, T, cfg.dim) @ blk["wo"]
        x = _mlp(x, blk)
    if last_index is not None:
        x = x[:, min(max(int(last_index), 0), T - 1)]
    elif last_only:
        x = x[:, -1]
    x = _ln(x, params["ln_f"])
    return x @ params["embed"].T  # weight-tied output head


def loss_fn(params, tokens, cfg: TransformerConfig, mesh=None,
            attn_impl: str = "ring"):
    """Next-token cross entropy over tokens [B, T+1] (input/target
    split): log-softmax of the f32 logits, mean over every position."""
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    logits = forward(params, inp, cfg, mesh=mesh, attn_impl=attn_impl)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, tgt.long()[..., None])[..., 0]
    return nll.mean()


def _leaves(tree):
    """The tensors of a parameter tree, in jax.tree_util's leaf order
    (dictionary keys sorted)."""
    if isinstance(tree, dict):
        return [t for key in sorted(tree) for t in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def make_train_step(cfg: TransformerConfig, lr=1e-2, mesh=None,
                    attn_impl: str = "ring"):
    """Plain SGD: step(params, tokens) -> (params, loss) with
    p <- p - lr * g in the parameter dtype. Unlike the reference, which
    returns a new pytree, the step UPDATES THE PARAMETER TENSORS IN
    PLACE (under torch.no_grad) and returns the same dictionary. It
    sets `requires_grad` on the tensors it is given (they must be leaf
    tensors, as `init_params` and `params_from_numpy` make them)."""

    def step(params, tokens):
        leaves = _leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = loss_fn(params, tokens, cfg, mesh=mesh, attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, leaves)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(g * lr)  # lr * g rounds to p's dtype, as in JAX
        return params, loss.detach()

    return step


# ---------------------------------------------------------------------
# incremental decoding: per-layer contiguous KV cache + one-token steps
# ---------------------------------------------------------------------


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len=None,
                  dtype=None, device=None):
    """Per-layer K/V buffers [B, L, H, Dh], zero-initialised."""
    dev = resolve_device(device)
    L = int(max_len or cfg.max_len)
    shape = (batch, L, cfg.heads, cfg.dim // cfg.heads)
    dt = dtype or cfg.dtype
    return [{"k": torch.zeros(shape, dtype=dt, device=dev),
             "v": torch.zeros(shape, dtype=dt, device=dev)}
            for _ in range(cfg.layers)]


def _cached_attention(q, cache_k, cache_v, pos):
    """q [B, H, Dh] against the cache [B, L, H, Dh]; depths > pos masked
    with -inf. `pos` is a scalar (every row at one depth) or a [B]
    vector of per-row positions. Decode family: scores / sqrt(Dh) after
    the matmul, softmax in f32."""
    B, L, H, dh = cache_k.shape
    # a bf16 q over an f32 (dequantized) cache computes in f32, as JAX
    # promotes; the probabilities still round to q's dtype
    ct = torch.promote_types(q.dtype, cache_k.dtype)
    scores = torch.einsum("bhd,blhd->bhl", q.to(ct), cache_k) / math.sqrt(dh)
    depth = torch.arange(L, device=q.device)
    if isinstance(pos, int) or pos.dim() == 0:
        mask = (depth <= pos)[None, None, :]
    else:
        mask = (depth[None, :] <= pos[:, None])[:, None, :]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhl,blhd->bhd", probs.to(ct), cache_v)


def _write_kv(buf, new, pos):
    """Write one new K or V row [B, H, Dh] into the cache [B, L, H, Dh]
    at position `pos` (scalar: every row; [B]: per row, out-of-range
    rows dropped as JAX's scatter drops them). In place."""
    if isinstance(pos, int) or pos.dim() == 0:
        buf[:, int(pos)] = new.to(buf.dtype)
        return buf
    rows = torch.nonzero((pos >= 0) & (pos < buf.shape[1]),
                         as_tuple=True)[0]
    buf[rows, pos[rows].long()] = new[rows].to(buf.dtype)
    return buf


def decode_step(params, token, pos, cache, cfg: TransformerConfig):
    """One decode step: token [B] at position `pos` (scalar or [B]) ->
    (logits [B, vocab], cache updated in place)."""
    B = token.shape[0]
    dh = cfg.dim // cfg.heads
    x = params["embed"][token.long()] + _pos_rows(params, pos)
    for blk, kv in zip(params["blocks"], cache):
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"]).reshape(B, cfg.heads, dh)
        k = (h @ blk["wk"]).reshape(B, cfg.heads, dh)
        v = (h @ blk["wv"]).reshape(B, cfg.heads, dh)
        _write_kv(kv["k"], k, pos)
        _write_kv(kv["v"], v, pos)
        o = _cached_attention(q, kv["k"], kv["v"], pos).reshape(B, cfg.dim)
        x = x + o @ blk["wo"]
        x = _mlp(x, blk)
    x = _ln(x, params["ln_f"])
    return x @ params["embed"].T, cache


def prefill(params, tokens, cfg: TransformerConfig, max_len=None):
    """Run the prompt [B, T0] once through forward() (kv_sink hook),
    filling a fresh cache; returns (logits of the last prompt position
    [B, vocab], cache)."""
    B, T0 = tokens.shape
    cache = init_kv_cache(cfg, B, max_len=max_len,
                          dtype=params["embed"].dtype,
                          device=tokens.device)
    sink: list = []
    logits = forward(params, tokens, cfg, attn_impl="reference",
                     kv_sink=sink, last_only=True)
    for kv, (k, v) in zip(cache, sink):
        kv["k"][:, :T0] = k.to(kv["k"].dtype)
        kv["v"][:, :T0] = v.to(kv["v"].dtype)
    return logits, cache


def generate(params, prompt, cfg: TransformerConfig, max_new_tokens,
             temperature=0.0, key=None, max_len=None, eos_id=None):
    """Autoregressive generation: prefill the prompt [B, T0], then
    `max_new_tokens` cached decode steps. temperature <= 0 is greedy;
    otherwise softmax sampling with `key` (a utils.prng key), split
    once per step exactly like the reference. With `eos_id`, a row that
    emits it keeps re-emitting it and the loop stops once every row
    has. Returns [B, T0 + max_new]."""
    B, T0 = prompt.shape
    L = min(int(max_len or cfg.max_len), int(params["pos"].shape[0]))
    if T0 + max_new_tokens > L:
        raise ValueError(
            "generate needs T0+max_new <= max_len (%d + %d > %d, "
            "positional table %d)"
            % (T0, max_new_tokens, L, int(params["pos"].shape[0])))
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) requires `key`")
    logits, cache = prefill(params, prompt, cfg, max_len=L)
    key = key if key is not None else prng.PRNGKey(0, prompt.device)
    alive = torch.ones(B, dtype=torch.bool, device=prompt.device)
    out = []
    for i in range(max_new_tokens):
        if eos_id is not None and not bool(alive.any()):
            break
        if temperature <= 0:
            tok = torch.argmax(logits, dim=-1)
        else:  # the reference splits every step; greedy never reads it
            key, sub = prng.split(key)
            tok = prng.categorical(sub, logits.float() / temperature)
        tok = tok.to(prompt.dtype)
        if eos_id is not None:
            tok = torch.where(alive, tok, torch.full_like(tok, eos_id))
            alive = alive & (tok != eos_id)
        out.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, tok, T0 + i, cache, cfg)
    gen = (torch.stack(out, dim=1) if out
           else prompt.new_zeros((B, 0)))
    if gen.shape[1] < max_new_tokens:  # early exit: the tail is eos
        pad = torch.full((B, max_new_tokens - gen.shape[1]), int(eos_id),
                         dtype=prompt.dtype, device=prompt.device)
        gen = torch.cat([gen, pad], dim=1)
    return torch.cat([prompt, gen], dim=1)


# ---------------------------------------------------------------------
# paged KV cache (serving): a pool of fixed-size token BLOCKS
# ([NB, Bt, H, Dh] per layer) and per-slot block TABLES of physical ids.
# Each primitive takes kernel="gather"|"fused":
#   gather — attend over a contiguous per-slot view that `paged_view`
#            (parallel/paged_attention.py) materialises (the reference
#            numerics, verbatim);
#   fused  — the paged-attention wrappers in parallel/paged_attention.py
#            walk the block table inside the Hopper kernel (on a CPU
#            tensor, its plain PyTorch version).
# ---------------------------------------------------------------------


def _check_paged(kernel, kv_quant):
    if kernel not in ("gather", "fused"):
        raise ValueError("paged kernel must be 'gather' or 'fused' (got %r)"
                         % (kernel,))
    _kv_quant_check(kv_quant)


# ---------------------------------------------------------------------
# per-block KV quantization: the pool stores int8/fp8 codes with a
# per-(physical block, head) absmax scale side-band [NB, H] per layer
# and band. Scales are keyed by PHYSICAL block id, so prefix aliasing
# shares the scale and copy-on-write copies it with the payload. qmax is
# the storage format's largest magnitude: 127 for int8, 448 for
# float8_e4m3fn (no inf: writes clip to it before the cast).
# ---------------------------------------------------------------------

_KV_QMAX = {"int8": 127.0, "fp8": 448.0}


def _kv_quant_check(kv_quant: str):
    if kv_quant not in ("none", "int8", "fp8"):
        raise ValueError("kv_quant must be 'none', 'int8', or 'fp8' (got %r)"
                         % (kv_quant,))


def kv_block_bytes(layers_n: int, heads: int, dh: int, block_tokens: int,
                   kv_quant: str = "none", act_itemsize: int = 4) -> int:
    """One physical KV block's device-memory cost at its storage dtype:
    K + V rows over all layers, plus the per-(block, head) f32 scale
    side-bands when quantized. The one formula: the engine's allocator
    and chip_smoke.py's byte budget both call it."""
    _kv_quant_check(kv_quant)
    item = 1 if kv_quant != "none" else int(act_itemsize)
    b = 2 * layers_n * block_tokens * heads * dh * item
    if kv_quant != "none":
        b += 2 * layers_n * heads * 4
    return b


def kv_storage_dtype(kv_quant: str):
    """Pool storage dtype for a kv_quant setting; None = the model dtype
    (unquantized)."""
    _kv_quant_check(kv_quant)
    return {"int8": torch.int8, "fp8": torch.float8_e4m3fn}.get(kv_quant)


def init_paged_kv_cache(cfg: TransformerConfig, num_blocks: int,
                        block_tokens: int, dtype=None, kv_quant="none",
                        device=None):
    """Per-layer pooled K/V block buffers [NB, Bt, H, Dh], zeros. With
    `kv_quant` ('int8' | 'fp8') the payload stores codes and each layer
    gains per-(block, head) f32 scale side-bands 'k_scale'/'v_scale'
    [NB, H] (committed when a block is opened, `_quant_scatter`);
    'none' returns the unquantized structure."""
    dev = resolve_device(device)
    NB, H = int(num_blocks), cfg.heads
    shape = (NB, int(block_tokens), H, cfg.dim // H)
    st = kv_storage_dtype(kv_quant)
    if st is None:
        dt = dtype or cfg.dtype
        return [{"k": torch.zeros(shape, dtype=dt, device=dev),
                 "v": torch.zeros(shape, dtype=dt, device=dev)}
                for _ in range(cfg.layers)]
    return [{"k": torch.zeros(shape, dtype=st, device=dev),
             "v": torch.zeros(shape, dtype=st, device=dev),
             "k_scale": torch.zeros((NB, H), dtype=torch.float32, device=dev),
             "v_scale": torch.zeros((NB, H), dtype=torch.float32, device=dev)}
            for _ in range(cfg.layers)]


def _quant_scatter(buf, scale, pk, off, vals, qmax, commit_from_call=False,
                   writer=None):
    """Quantize rows `vals` [..., H, Dh] and write them into the int8/fp8
    pool `buf` [NB, Bt, H, Dh] at (pk, off) [...]; updates `buf` and
    `scale` [NB, H] IN PLACE and returns them.

    The absmax commit-at-open rule of the reference: a block is OPENED
    when some row of this call writes its offset 0, and an opened block
    (re)commits its per-head scale, erasing the stale scale a recycled
    block carries. The commit source is the opening ROW's absmax
    (row-commit: decode and verify, so rejected draft rows of a verify
    window never reach a scale and quantized spec decode emits the
    plain path's tokens), or with `commit_from_call` the absmax over
    every row this call writes into the block (call-commit: prefill
    chunks). Rows landing in a block this call did not open re-use its
    committed scale and clip to it. Parked rows (pk == NB) drop payload,
    scale commit and open marker alike. `writer` is the call's
    `_RowWriter` for (pk, off) when the caller already made one."""
    NB, H = scale.shape
    dh = vals.shape[-1]
    fpk = pk.reshape(-1).long()
    n = fpk.shape[0]
    opens = off.reshape(-1) == 0
    fv = vals.reshape(n, H, dh).float()
    amax = fv.abs().amax(dim=-1)  # [n, H]
    # commit-source rows scatter-max into the candidate scales in an
    # [NB + 1, H] buffer whose last row takes (and drops) the parked
    # rows (pk == NB) and, in row-commit mode, the non-opening rows
    src = fpk if commit_from_call else torch.where(
        opens, fpk, torch.full_like(fpk, NB))
    cand = torch.zeros((NB + 1, H), dtype=torch.float32, device=fv.device)
    cand.scatter_reduce_(0, src[:, None].expand(n, H), amax / qmax, "amax")
    opened = torch.zeros(NB + 1, dtype=torch.float32, device=fv.device)
    opened.scatter_reduce_(0, fpk, opens.float(), "amax")
    new_scale = torch.where(opened[:NB, None] > 0, cand[:NB], scale)
    # each row quantizes with the post-commit scale of its block; a zero
    # scale divides by 1, so exact 0 round-trips to exact 0
    s_rows = new_scale[fpk.clamp(0, NB - 1)][..., None]  # [n, H, 1]
    codes = fv / torch.where(s_rows > 0, s_rows, torch.ones_like(s_rows))
    if buf.dtype == torch.int8:
        codes = torch.round(codes)  # half to even, as jnp.round
    # fp8: clip to the format's finite max BEFORE the cast
    codes = codes.clamp(-qmax, qmax).reshape(tuple(pk.shape) + (H, dh))
    (writer or _RowWriter(pk, off, NB)).write(buf, codes)
    scale.copy_(new_scale)
    return buf, scale


def _slot_views(kv, ksc, vsc, tables):
    """One layer's per-slot K/V views [S, MAXB*Bt, H, Dh] through
    `tables`: the gathered pool, or its f32 dequantized view (the JAX
    package's `_paged_deq_view`) when the layer holds codes (scales
    given)."""
    return paged_view(kv["k"], tables, ksc), paged_view(kv["v"], tables, vsc)


def _phys_rows(tables, wpos, NB, Bt):
    """Map global write positions to (physical block, in-block offset).
    A position past the table span (parked rows sit at MAXB*Bt) or on an
    unallocated (-1) entry resolves to block NB: out of range, dropped
    by `_scatter_rows`."""
    tables = tables.long()
    wpos = wpos.long()
    maxb = tables.shape[-1]
    bi = torch.div(wpos, Bt, rounding_mode="floor")
    safe = bi.clamp(0, maxb - 1)
    if tables.dim() == 1:
        phys = tables[safe]
    elif safe.dim() == tables.dim():
        phys = torch.gather(tables, -1, safe)
    else:  # one position per table row (the decode step's [S] case)
        phys = torch.gather(tables, -1, safe[..., None])[..., 0]
    phys = torch.where((bi < maxb) & (phys >= 0), phys,
                       torch.full_like(phys, NB))
    return phys, wpos % Bt


class _RowWriter(object):
    """The cache writes of one primitive call, with the rows
    `_phys_rows` parked at block NB dropped WITHOUT reading anything back
    to the host (no `nonzero`, no boolean mask), so a decode window can
    be dispatched while the previous one still runs.

    Every row is written, but a parked row is redirected to the target
    of the call's first live row and carries that row's own bytes; when
    no row of the call is live, every parked row rewrites block 0's
    offset 0 with the bytes it already holds. Duplicate targets in one
    scatter therefore always carry identical bytes, so the write is
    deterministic, a parked row never changes what a live row wrote,
    and the pool needs no sink block (`kv_block_bytes` stays its true
    cost and the kernels' shape checks are unchanged)."""

    def __init__(self, pk, off, NB):
        self.pk_all, self.off_all = pk, off
        fpk, foff = pk.reshape(-1).long(), off.reshape(-1).long()
        n = fpk.shape[0]
        live = fpk < NB
        idx = torch.arange(n, device=fpk.device)
        own = torch.where(live, idx, n)
        # each row's source among the rows plus one extra row n (block 0
        # offset 0's current bytes): itself when live, else the first
        # live row, else the extra row
        self.src = torch.where(live, own, own.amin(dim=0, keepdim=True))
        self.pk = F.pad(fpk, (0, 1)).index_select(0, self.src)
        self.off = F.pad(foff, (0, 1)).index_select(0, self.src)

    def write(self, buf, rows):
        """rows [..., H, Dh] shaped like pk -> written into buf in place
        (cast to buf's dtype; fp8 codes through the byte view)."""
        raw = raw_bytes(buf)
        vals = raw_bytes(rows.to(buf.dtype)).reshape(
            (self.src.shape[0],) + tuple(raw.shape[2:]))
        ext = torch.cat([vals, raw[:1, 0]])
        raw.index_put_((self.pk, self.off), ext.index_select(0, self.src))


def _write_layer(kv, writer, k, v, qmax, commit_from_call=False):
    """Write one layer's new K/V rows through `writer` (in place):
    quantized at the scatter when the pool holds codes (`qmax` set).
    Returns the layer's (k_scale, v_scale), None when unquantized."""
    if qmax is None:
        writer.write(kv["k"], k)
        writer.write(kv["v"], v)
        return None, None
    for band, rows in (("k", k), ("v", v)):
        _quant_scatter(kv[band], kv[band + "_scale"], writer.pk_all,
                       writer.off_all, rows, qmax, commit_from_call, writer)
    return kv["k_scale"], kv["v_scale"]


def _adapter_delta(h, a, b, scale):
    """LoRA-style low-rank delta h @ A @ B * scale with per-slot adapter
    gathers: `a` is [d, r] (one slot, the prefill chunk's scalar index)
    or [S, d, r] (decode [S, d] and verify [S, K, d] activations); `b`
    and `scale` match. Computed in the pool's dtype (f32), as JAX
    promotes. The zero adapter (A = B = 0, scale 0) gives exact zeros."""
    h = h.to(torch.promote_types(h.dtype, a.dtype))
    if a.dim() == 2:  # one slot
        return (h @ a) @ b * scale
    if h.dim() == 2:  # decode: [S, d] x [S, d, r]
        t = torch.einsum("sd,sdr->sr", h, a)
        return torch.einsum("sr,srd->sd", t, b) * scale[:, None]
    t = torch.einsum("skd,sdr->skr", h, a)  # verify: [S, K, d]
    return torch.einsum("skr,srd->skd", t, b) * scale[:, None, None]


def _adapter_qv(h, blk, li, adapters, idx):
    """q/v projections of layer `li` with the per-slot adapter delta
    folded in, shared by the three paged primitives. `idx` is the
    adapter-index band (an int for the chunk's one slot, [S] otherwise);
    `adapters` the stacked pool ([P, layers, ...], serving/adapters.py).
    The f32 delta is cast to the activation dtype BEFORE the add, so the
    zero adapter leaves a bf16 model bit-identical to the base model.
    Returns (q, v) unshaped."""
    q = h @ blk["wq"]
    v = h @ blk["wv"]
    if adapters is not None:
        if isinstance(idx, torch.Tensor):
            idx = idx.long()
        sc = adapters["scale"][idx]
        dq = _adapter_delta(h, adapters["a_q"][idx, li],
                            adapters["b_q"][idx, li], sc)
        dv = _adapter_delta(h, adapters["a_v"][idx, li],
                            adapters["b_v"][idx, li], sc)
        q = q + dq.to(q.dtype)
        v = v + dv.to(v.dtype)
    return q, v


def paged_decode_step(params, token, pos, tables, cache,
                      cfg: TransformerConfig, adapters=None,
                      adapter_idx=None, kernel="gather", kv_quant="none"):
    """One decode step over the paged pool: token [S] at per-row
    positions `pos` [S], block tables [S, MAXB] -> (logits [S, vocab],
    cache updated in place). A parked row (pos >= MAXB*Bt) writes
    nothing; its logits are garbage nothing reads. With `kv_quant`
    ('int8' | 'fp8') writes quantize at the scatter (row-commit) and
    reads dequantize in the kernel or on the gathered view."""
    _check_paged(kernel, kv_quant)
    qmax = _KV_QMAX.get(kv_quant)
    B = token.shape[0]
    dh = cfg.dim // cfg.heads
    NB, Bt = cache[0]["k"].shape[0], cache[0]["k"].shape[1]
    x = params["embed"][token.long()] + _pos_rows(params, pos)
    writer = _RowWriter(*_phys_rows(tables, pos, NB, Bt), NB)
    for li, (blk, kv) in enumerate(zip(params["blocks"], cache)):
        h = _ln(x, blk["ln1"])
        q, v = _adapter_qv(h, blk, li, adapters, adapter_idx)
        q = q.reshape(B, cfg.heads, dh)
        k = (h @ blk["wk"]).reshape(B, cfg.heads, dh)
        v = v.reshape(B, cfg.heads, dh)
        ksc, vsc = _write_layer(kv, writer, k, v, qmax)
        if kernel == "fused":
            from ..parallel.paged_attention import paged_decode_attention

            o = paged_decode_attention(q, kv["k"], kv["v"], tables, pos,
                                       k_scale=ksc, v_scale=vsc)
        else:
            # over an f32 dequantized view the output is f32: cast it back
            # to the activation dtype (the kernel's output is q's already)
            kview, vview = _slot_views(kv, ksc, vsc, tables)
            o = _cached_attention(q, kview, vview, pos).to(x.dtype)
        x = x + o.reshape(B, cfg.dim) @ blk["wo"]
        x = _mlp(x, blk)
    x = _ln(x, params["ln_f"])
    return x @ params["embed"].T, cache


def paged_prefill_chunk(params, cache, chunk, start_pos, table_row,
                        cfg: TransformerConfig, true_len=None,
                        adapters=None, adapter_idx=None, kernel="gather",
                        kv_quant="none"):
    """Extend the slot whose block table is `table_row` [MAXB] by a
    [C]-token chunk whose first token sits at position `start_pos`
    (tokens before it already cached). Each chunk row attends
    cache[0:start_pos] plus the intra-chunk causal prefix, with
    reference_attention's numerics (scale folded into q, NEG_INF mask).
    `chunk` may be padded: `true_len` is the count of real tokens, and
    padded rows park their writes past the table span. Returns (logits
    [vocab] of the true last chunk row, cache updated in place). With
    `kv_quant` a chunk commits the scale of every block it opens from
    all its rows in that block (call-commit) and clips into blocks an
    earlier chunk committed; reads dequantize as in paged_decode_step."""
    _check_paged(kernel, kv_quant)
    qmax = _KV_QMAX.get(kv_quant)
    (C,) = chunk.shape
    NB, Bt, H, dh = cache[0]["k"].shape
    dev = chunk.device
    Lv = table_row.shape[0] * Bt
    true_len = C if true_len is None else int(true_len)
    scale = 1.0 / math.sqrt(dh)
    offs = torch.arange(C, device=dev)
    positions = offs + start_pos  # [C] global rows of the chunk
    wpos = torch.where(offs < true_len, positions,
                       torch.full_like(positions, Lv))
    x = params["embed"][chunk.long()][None] + _pos_rows(params, positions)[None]
    writer = _RowWriter(*_phys_rows(table_row, wpos, NB, Bt), NB)
    for li, (blk, kv) in enumerate(zip(params["blocks"], cache)):
        h = _ln(x, blk["ln1"])
        q, v = _adapter_qv(h, blk, li, adapters, adapter_idx)
        q = q.reshape(1, C, H, dh)
        k = (h @ blk["wk"]).reshape(1, C, H, dh)
        v = v.reshape(1, C, H, dh)
        ksc, vsc = _write_layer(kv, writer, k[0], v[0], qmax,
                                commit_from_call=True)
        if kernel == "fused":
            from ..parallel.paged_attention import paged_prefill_attention

            o = paged_prefill_attention(q[0], kv["k"], kv["v"], table_row,
                                        start_pos, k_scale=ksc,
                                        v_scale=vsc)[None]
        else:
            slot_k, slot_v = _slot_views(kv, ksc, vsc, table_row[None])
            s = torch.einsum("bthd,bshd->bhts",
                             (q * scale).to(slot_k.dtype), slot_k)
            mask = torch.arange(Lv, device=dev)[None, :] <= positions[:, None]
            s = s.masked_fill(~mask[None, None], NEG_INF)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bhts,bshd->bthd", p, slot_v).to(x.dtype)
        x = x + o.reshape(1, C, cfg.dim) @ blk["wo"]
        x = _mlp(x, blk)
    xl = x[:, min(max(true_len - 1, 0), C - 1)]  # [1, dim]
    xl = _ln(xl, params["ln_f"])
    return (xl @ params["embed"].T)[0], cache


def paged_verify_step(params, cache, window, pos, wpos, tables,
                      cfg: TransformerConfig, adapters=None,
                      adapter_idx=None, kernel="gather", kv_quant="none"):
    """Speculative-decoding verify: a K-token `window` [S, K] per slot
    through the paged cache in one batched step -> (logits [S, K,
    vocab], cache updated in place). Row (s, i) sits at position
    pos[s] + i and attends the slot's cache up to and including itself;
    `wpos` [S, K] are the write positions (parked rows >= MAXB*Bt are
    dropped). Chunk-family numerics. With `kv_quant` a window row
    opening a block commits its scale alone (row-commit: rejected draft
    rows never reach a scale) and reads dequantize as in
    paged_decode_step."""
    _check_paged(kernel, kv_quant)
    qmax = _KV_QMAX.get(kv_quant)
    S, K = window.shape
    NB, Bt, H, dh = cache[0]["k"].shape
    dev = window.device
    Lv = tables.shape[1] * Bt
    scale = 1.0 / math.sqrt(dh)
    positions = pos.long()[:, None] + torch.arange(K, device=dev)[None, :]
    x = params["embed"][window.long()] + _pos_rows(params, positions)
    writer = _RowWriter(*_phys_rows(tables, wpos, NB, Bt), NB)
    for li, (blk, kv) in enumerate(zip(params["blocks"], cache)):
        h = _ln(x, blk["ln1"])
        q, v = _adapter_qv(h, blk, li, adapters, adapter_idx)
        q = q.reshape(S, K, H, dh)
        k = (h @ blk["wk"]).reshape(S, K, H, dh)
        v = v.reshape(S, K, H, dh)
        ksc, vsc = _write_layer(kv, writer, k, v, qmax)
        if kernel == "fused":
            from ..parallel.paged_attention import paged_verify_attention

            o = paged_verify_attention(q, kv["k"], kv["v"], tables, pos,
                                       k_scale=ksc, v_scale=vsc)
        else:
            kview, vview = _slot_views(kv, ksc, vsc, tables)
            s = torch.einsum("bthd,bshd->bhts",
                             (q * scale).to(kview.dtype), kview)
            mask = (torch.arange(Lv, device=dev)[None, None, :]
                    <= positions[:, :, None])
            s = s.masked_fill(~mask[:, None], NEG_INF)
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bhts,bshd->bthd", p, vview).to(x.dtype)
        x = x + o.reshape(S, K, cfg.dim) @ blk["wo"]
        x = _mlp(x, blk)
    x = _ln(x, params["ln_f"])
    return x @ params["embed"].T, cache


def logits_trap(logits):
    """Per-row non-finite trap over final logits [..., V]: True where a
    row holds any NaN/Inf or its softmax denominator is non-finite or
    non-positive (a zero-mass distribution is as corrupt as a NaN)."""
    finite = torch.isfinite(logits).all(dim=-1)
    f32 = logits.float()
    denom = torch.exp(f32 - f32.amax(dim=-1, keepdim=True)).sum(dim=-1)
    return ~finite | ~torch.isfinite(denom) | (denom <= 0.0)


def logit_amax(logits, mask=None):
    """Scalar max-|logit| over the (optionally masked) rows — the
    sentinel's spike signal. Masked rows contribute 0."""
    a = logits.float().abs().amax(dim=-1)
    if mask is not None:
        while mask.dim() < a.dim():
            mask = mask[..., None]
        a = torch.where(mask, a, torch.zeros_like(a))
    return a.max()


def decode_window_retire(alive, nxt, pos, limits, eos_ids):
    """In-window retirement for the decode window, the branch-free
    device mirror of the engine's `_emit` rule applied after every
    iteration: a slot that samples its EOS id (`eos_ids` [S], -1 = none)
    or whose advanced position reaches `limits - 1` (its budget is
    spent) emits that token and goes dead for the rest of the window;
    dead slots do not advance. Returns (alive, pos) after the
    iteration."""
    live = alive.to(pos.dtype)
    npos = pos + live
    hit_eos = (eos_ids >= 0) & (nxt == eos_ids)
    nalive = alive & ~hit_eos & (npos < limits - 1)
    return nalive, npos


def paged_block_fingerprint(cache, bid):
    """Folded f32 checksum of ONE physical KV block across every layer
    and band (payload rows and, on a quantized pool, the per-head scale
    rows), as a 0-d f32 tensor: position-weighted (element index mod 97,
    plus 1) so a transposition inside the block moves it, and folded per
    band and layer with distinct multipliers so a value moving between K
    and V or between layers cannot cancel. Deterministic for fixed
    shapes on one device; the summation order differs from the JAX
    package's, so the two agree to float rounding, not bit for bit."""
    acc = None
    for li, kv in enumerate(cache):
        for bi, band in enumerate(sorted(kv)):
            x = kv[band][int(bid)].float().reshape(-1)
            w = torch.arange(x.shape[0], dtype=torch.float32,
                             device=x.device) % 97.0 + 1.0
            fold = float(np.float32(1.0 + 0.013 * (li * 7 + bi + 1)))
            term = torch.sum(x * w) * fold
            acc = term if acc is None else acc + term
    return acc
