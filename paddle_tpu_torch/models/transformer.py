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
integrity layer. `prefill_chunk` extends one slot of a slotted cache
chunk by chunk and `beam_search_generate` decodes beams over the cache
(`LAST_DECODE_STATS` counts its steps).

Switch-MoE: with `moe_experts > 0` every `moe_every`-th block's MLP is
a top-1 MoE FFN (parallel/moe.py), its parameters under "moe"; on a
mesh with an 'expert' axis of extent > 1 `forward` routes it through
`expert_parallel_moe`, everywhere else through `reference_moe`.

On a mesh (one process per rank, parallel/mesh.py) `forward` keeps the
JAX package's global view: tokens and parameters are whole on every
rank, or parameters laid out by `param_specs` (`shard_params` gives a
rank its blocks) and gathered at use; the embedding is a row-sharded
lookup over 'model', attention sequence-parallel over 'seq'
(parallel/attention.py), MoE expert-parallel over 'expert', and every
rank computes the same logits. `loss_and_grads` seeds the backward of
that replicated loss with 1 / ranks and sums each gradient over the
axes its parameter is not split over, so every rank ends with the
global gradient (the Fluid mesh's rule, fluid/core/spmd.py).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from ..parallel import collectives
from ..parallel.attention import sequence_parallel_attention
from ..parallel.collectives import MeshAxis
from ..parallel.kernel_utils import NEG_INF, raw_bytes
from ..parallel.mesh import PartitionSpec as P
from ..parallel.moe import expert_parallel_moe, reference_moe
from ..parallel.paged_attention import paged_view
from ..utils import prng
from ..utils.tree import leaves as _leaves

__all__ = ["TransformerConfig", "init_params", "params_from_numpy",
           "param_shapes", "param_specs", "shard_params", "forward",
           "loss_fn", "loss_and_grads", "make_train_step", "init_kv_cache",
           "decode_step", "prefill", "prefill_chunk",
           "generate", "beam_search_generate", "LAST_DECODE_STATS",
           "init_paged_kv_cache", "kv_block_bytes",
           "kv_storage_dtype",
           "paged_decode_step", "paged_prefill_chunk",
           "paged_verify_step", "logits_trap", "logit_amax",
           "decode_window_retire", "paged_block_fingerprint"]


class TransformerConfig:
    def __init__(self, vocab=256, dim=128, heads=4, layers=2, mlp_mult=4,
                 max_len=1024, dtype=torch.float32, moe_experts=0,
                 moe_every=2, moe_capacity_factor=1.25):
        self.vocab = vocab
        self.dim = dim
        self.heads = heads
        self.layers = layers
        self.mlp_mult = mlp_mult
        self.max_len = max_len
        self.dtype = dtype
        # Switch-Transformer MoE: with moe_experts > 0, every
        # `moe_every`-th block's MLP becomes a top-1 MoE FFN
        self.moe_experts = moe_experts
        self.moe_every = moe_every
        self.moe_capacity_factor = moe_capacity_factor

    def is_moe_block(self, i: int) -> bool:
        return self.moe_experts > 0 and (i % self.moe_every
                                         == self.moe_every - 1)


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The parameter tree's shapes as torch.Size leaves: {"embed",
    "pos", "blocks", "ln_f"}, a block's MLP under "moe" ({gate_w, w1,
    b1, w2, b2}) where `cfg.is_moe_block`."""
    d, m, E = cfg.dim, cfg.mlp_mult * cfg.dim, cfg.moe_experts
    S = torch.Size  # a leaf, where a plain tuple is a container
    ln = {"g": S((d,)), "b": S((d,))}

    def block(i):
        b = {"ln1": dict(ln), "wq": S((d, d)), "wk": S((d, d)),
             "wv": S((d, d)), "wo": S((d, d)), "ln2": dict(ln)}
        if cfg.is_moe_block(i):
            b["moe"] = {"gate_w": S((d, E)), "w1": S((E, d, m)),
                        "b1": S((E, m)), "w2": S((E, m, d)),
                        "b2": S((E, d))}
        else:
            b["w1"], b["w2"] = S((d, m)), S((m, d))
        return b

    return {"embed": S((cfg.vocab, d)), "pos": S((cfg.max_len, d)),
            "blocks": [block(i) for i in range(cfg.layers)],
            "ln_f": dict(ln)}


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random parameters with the reference's shapes and law (dense
    weights N(0, 1) / sqrt(dim), LayerNorm gains 1, LayerNorm and MoE
    biases 0), drawn from `generator` on its own device and placed on
    `device` (CUDA by default). The numbers differ from the JAX init of
    the same seed; use `params_from_numpy` to carry JAX weights over."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(cfg.dim)

    def make(name, shape):
        if name == "g":
            return torch.ones(shape, device=dev, dtype=cfg.dtype)
        if name in ("b", "b1", "b2"):
            return torch.zeros(shape, device=dev, dtype=cfg.dtype)
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (scale * w).to(device=dev, dtype=cfg.dtype)

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return make(name, tree)

    return walk(param_shapes(cfg))


def param_specs(cfg: TransformerConfig, mesh=None) -> Dict[str, Any]:
    """PartitionSpecs for tensor parallelism over 'model' (Megatron
    style: wq/wk/wv/w1 column-parallel, wo/w2 row-parallel, the
    embedding split along its rows) and expert-sharded MoE FFNs over
    'expert'. With `mesh`, axes the mesh does not have are dropped
    (MoE parameters replicate on a mesh without an 'expert' axis)."""
    rep = P()

    def fit(spec):
        if mesh is None:
            return spec
        return P(*(a if a in mesh.axis_names else None for a in spec))

    def block(i):
        b = {"ln1": {"g": rep, "b": rep}, "wq": fit(P(None, "model")),
             "wk": fit(P(None, "model")), "wv": fit(P(None, "model")),
             "wo": fit(P("model", None)), "ln2": {"g": rep, "b": rep}}
        if cfg.is_moe_block(i):
            b["moe"] = {"gate_w": rep, "w1": fit(P("expert", None, None)),
                        "b1": fit(P("expert", None)),
                        "w2": fit(P("expert", None, None)),
                        "b2": fit(P("expert", None))}
        else:
            b["w1"] = fit(P(None, "model"))
            b["w2"] = fit(P("model", None))
        return b

    return {"embed": fit(P("model", None)), "pos": rep,
            "blocks": [block(i) for i in range(cfg.layers)],
            "ln_f": {"g": rep, "b": rep}}


def _zip_specs(params, specs, shapes, fn):
    """`fn(leaf, spec, full_shape)` over the parameter tree."""
    if isinstance(params, dict):
        return {k: _zip_specs(params[k], specs[k], shapes[k], fn)
                for k in params}
    if isinstance(params, list):
        return [_zip_specs(p, s, f, fn)
                for p, s, f in zip(params, specs, shapes)]
    return fn(params, specs, shapes)


def _split_axes(leaf, spec, full, mesh):
    """[(dim, axis)] along which `leaf` holds a block of its full shape
    on `mesh` (a leaf given whole has none)."""
    return [(dim, a) for dim, a in enumerate(spec)
            if a is not None and mesh.shape[a] > 1
            and leaf.shape[dim] != full[dim]]


def shard_params(params, cfg: TransformerConfig, mesh):
    """This rank's blocks of whole parameters laid out by
    `param_specs(cfg, mesh)` (the port's counterpart of device_put with
    NamedShardings): a leaf split over an axis keeps block `index` of
    it along that dimension, the rest stay whole. Fresh leaf tensors."""
    def block(leaf, spec, full):
        for dim, a in enumerate(spec):
            if a is not None and mesh.shape[a] > 1:
                leaf = MeshAxis.of(mesh, a).block(leaf, dim)
        return leaf.detach().clone()

    return _zip_specs(params, param_specs(cfg, mesh), param_shapes(cfg),
                      block)


def _gather_params(params, cfg: TransformerConfig, mesh):
    """The whole parameters on every rank: leaves laid out by
    `param_specs` are gathered over their axes (differentiable: a
    block's gradient is summed over the axis), whole leaves pass."""
    def gather(leaf, spec, full):
        for dim, a in _split_axes(leaf, spec, full, mesh):
            leaf = MeshAxis.of(mesh, a).all_gather(leaf, dim)
        return leaf

    return _zip_specs(params, param_specs(cfg, mesh), param_shapes(cfg),
                      gather)


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


def _mlp(x, blk, mesh=None, capacity_factor=1.25):
    """x plus the block's MLP of its LayerNorm: the GELU MLP, or the
    Switch-MoE FFN where the block has one ("moe"), expert-parallel on
    a mesh with an 'expert' axis of extent > 1 and `reference_moe`
    everywhere else (the decode and serving paths pass no mesh)."""
    h = _ln(x, blk["ln2"])
    if "moe" not in blk:
        return x + F.gelu(h @ blk["w1"], approximate="tanh") @ blk["w2"]
    mp = blk["moe"]
    flat = h.reshape(-1, h.shape[-1])
    args = (flat, mp["gate_w"], mp["w1"], mp["b1"], mp["w2"], mp["b2"])
    if mesh is not None and "expert" in mesh.axis_names and \
            mesh.shape["expert"] > 1:
        y = expert_parallel_moe(*args, mesh=mesh,
                                capacity_factor=capacity_factor)
    else:
        y = reference_moe(*args)
    return x + y.reshape(h.shape)


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
    mesh (and no default mesh), attn_impl="flash" runs the flash kernels
    and every other impl the plain causal attention, as in the
    reference. On a `mesh` every rank computes the same logits (the
    module docstring)."""
    if mesh is not None:
        params = _gather_params(params, cfg, mesh)
    B, T = tokens.shape
    H, dh = cfg.heads, cfg.dim // cfg.heads
    if mesh is not None and "model" in mesh.axis_names:
        from ..parallel.embedding import sharded_lookup

        rows = MeshAxis.of(mesh, "model").block(params["embed"], 0)
        x = sharded_lookup(rows, tokens, mesh, "model")
    else:
        x = params["embed"][tokens.long()]
    x = x + params["pos"][:T][None]
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
        x = _mlp(x, blk, mesh, cfg.moe_capacity_factor)
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


def _sync_mesh_grads(params, grads, cfg: TransformerConfig, mesh):
    """Each gradient summed over the mesh axes its parameter is not
    split over (a block's own axes were summed by its gather's
    backward), one bucketed sync per set of axes."""
    by_axes: Dict[tuple, dict] = {}
    for i, (p, spec, full) in enumerate(zip(
            _leaves(params), _leaves(param_specs(cfg, mesh)),
            _leaves(param_shapes(cfg)))):
        split = {a for _, a in _split_axes(p, spec, full, mesh)}
        rest = tuple(a for a in mesh.axis_names if a not in split)
        by_axes.setdefault(rest, {})[i] = grads[i]
    out = list(grads)
    for axes, part in by_axes.items():
        if axes:
            summed = collectives.sync_gradients(
                {str(i): g for i, g in part.items()}, mesh.group(axes),
                mesh.sync_stats)
            for i in part:
                out[i] = summed[str(i)]
    return out


def loss_and_grads(params, tokens, cfg: TransformerConfig, mesh=None,
                   attn_impl: str = "ring"):
    """(loss, gradients in `_leaves(params)` order) of `loss_fn` — the
    port's jax.value_and_grad of it. It sets `requires_grad` on the
    parameter tensors (leaf tensors, as `init_params`,
    `params_from_numpy` and `shard_params` make them). On a mesh every
    rank returns the global loss and the global gradient of its leaves:
    the backward is seeded with 1 / ranks and each gradient summed over
    the axes its parameter is not split over."""
    leaves = _leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_fn(params, tokens, cfg, mesh=mesh, attn_impl=attn_impl)
    seed = torch.full_like(loss, 1.0 / (mesh.size if mesh is not None
                                        else 1))
    grads = torch.autograd.grad(loss, leaves, grad_outputs=seed)
    if mesh is not None and mesh.size > 1:
        grads = _sync_mesh_grads(params, grads, cfg, mesh)
    return loss.detach(), list(grads)


def make_train_step(cfg: TransformerConfig, lr=1e-2, mesh=None,
                    attn_impl: str = "ring"):
    """Plain SGD: step(params, tokens) -> (params, loss) with
    p <- p - lr * g in the parameter dtype, g from `loss_and_grads` (on
    a mesh, the global gradient: every rank's parameters stay equal to
    the one-device step's). Unlike the reference, which returns a new
    pytree, the step UPDATES THE PARAMETER TENSORS IN PLACE (under
    torch.no_grad) and returns the same dictionary."""

    def step(params, tokens):
        loss, grads = loss_and_grads(params, tokens, cfg, mesh=mesh,
                                     attn_impl=attn_impl)
        with torch.no_grad():
            for p, g in zip(_leaves(params), grads):
                p.sub_(g * lr)  # lr * g rounds to p's dtype, as in JAX
        return params, loss

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


def prefill_chunk(params, cache, chunk, start_pos, slot,
                  cfg: TransformerConfig, true_len=None):
    """Multi-token incremental prefill of slot `slot` of a slotted cache
    ([S, L, H, Dh] per layer): the [C]-token `chunk`'s first token sits
    at position `start_pos` (tokens before it already cached). Each
    chunk row attends cache[0:start_pos] plus the chunk's causal
    prefix, with forward()'s numerics (reference_attention's scale
    folded into q and NEG_INF mask, softmax in the score dtype), so a
    prompt run chunk by chunk is the monolithic prefill. `chunk` may be
    padded: `true_len` counts its real tokens, and padded rows park at
    position L, where their writes are dropped. Returns (logits [vocab]
    of the true last chunk row — meaningful on a prompt's final chunk —
    and the cache, updated in place)."""
    (C,) = chunk.shape
    S, L, H, dh = cache[0]["k"].shape
    dev = chunk.device
    true_len = C if true_len is None else int(true_len)
    scale = 1.0 / math.sqrt(dh)
    offs = torch.arange(C, device=dev)
    positions = offs + int(start_pos)  # [C] global rows of the chunk
    live = offs < true_len  # padded rows park at L: nothing written
    rows = positions[live & (positions < L)]
    x = (params["embed"][chunk.long()][None]
         + _pos_rows(params, positions)[None])
    mask = torch.arange(L, device=dev)[None, :] <= positions[:, None]
    for blk, kv in zip(params["blocks"], cache):
        h = _ln(x, blk["ln1"])
        q = (h @ blk["wq"]).reshape(1, C, H, dh)
        k = (h @ blk["wk"]).reshape(1, C, H, dh)
        v = (h @ blk["wv"]).reshape(1, C, H, dh)
        n = rows.shape[0]
        kv["k"][slot, rows] = k[0, :n].to(kv["k"].dtype)
        kv["v"][slot, rows] = v[0, :n].to(kv["v"].dtype)
        slot_k, slot_v = kv["k"][slot][None], kv["v"][slot][None]
        s = torch.einsum("bthd,bshd->bhts", q * scale, slot_k)
        s = s.masked_fill(~mask[None, None], NEG_INF)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", p, slot_v)
        x = x + o.reshape(1, C, cfg.dim) @ blk["wo"]
        x = _mlp(x, blk)
    xl = x[:, min(max(true_len - 1, 0), C - 1)]  # [1, dim]
    xl = _ln(xl, params["ln_f"])
    return (xl @ params["embed"].T)[0], cache


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
    if eos_id is not None:
        LAST_DECODE_STATS["greedy_steps_executed"] = len(out)
        LAST_DECODE_STATS["greedy_max_steps"] = int(max_new_tokens)
    gen = (torch.stack(out, dim=1) if out
           else prompt.new_zeros((B, 0)))
    if gen.shape[1] < max_new_tokens:  # early exit: the tail is eos
        pad = torch.full((B, max_new_tokens - gen.shape[1]), int(eos_id),
                         dtype=prompt.dtype, device=prompt.device)
        gen = torch.cat([gen, pad], dim=1)
    return torch.cat([prompt, gen], dim=1)


# diagnostics of the last beam_search_generate call (executed vs maximum
# decode steps; the early exit stops once every beam has ended) and of
# the last generate(eos_id=...) call (greedy_*)
LAST_DECODE_STATS = {}


def beam_search_generate(params, prompt, cfg: TransformerConfig,
                         max_new_tokens, beam_size=4, alpha=0.0,
                         max_len=None):
    """Beam search over the KV cache. Beams live flattened on the batch
    dim ([B*W, ...]) so every step is the cached decode_step greedy
    uses; after each step's top-W of [B, W*V] candidates the caches and
    histories are gathered by parent beam. A beam that emitted eos
    (cfg.vocab - 1) is frozen: it re-emits eos at zero added cost. The
    loop stops once no beam is alive (one host read a step, as the
    reference's eager loop) and the skipped positions hold eos, exactly
    what the full schedule writes. Ties break by index as lax.top_k and
    jnp.argsort break them (stable sorts). Returns (tokens [B, W,
    T0+max_new], scores [B, W]) sorted best first, scores divided by
    the GNMT length penalty ((5 + len) / 6) ** alpha."""
    from ..fluid.core.kernels_nn import stable_topk

    B, T0 = prompt.shape
    W = int(beam_size)
    if max_new_tokens < 1:
        raise ValueError("beam_search_generate needs max_new_tokens >= 1")
    L = min(int(max_len or cfg.max_len), int(params["pos"].shape[0]))
    if T0 + max_new_tokens > L:
        raise ValueError(
            "beam_search_generate needs T0+max_new <= max_len "
            "(%d + %d > %d)" % (T0, max_new_tokens, L))
    eos, V = cfg.vocab - 1, cfg.vocab
    dev = prompt.device
    logits, cache = prefill(params, prompt, cfg, max_len=L)
    logp = torch.log_softmax(logits.float(), dim=-1)
    scores, top_tok = stable_topk(logp, W)  # [B, W]
    cache = [{k: t.repeat_interleave(W, dim=0) for k, t in kv.items()}
             for kv in cache]
    T_out = T0 + max_new_tokens
    tokens = prompt.new_zeros((B, W, T_out))
    tokens[:, :, :T0] = prompt[:, None]
    tokens[:, :, T0] = top_tok.to(prompt.dtype)
    alive = top_tok != eos
    frozen = torch.full((V,), float("-inf"), device=dev)
    frozen[eos] = 0.0
    base = (torch.arange(B, device=dev) * W)[:, None]
    steps = 0
    while steps < max_new_tokens - 1 and bool(alive.any()):
        pos = T0 + steps  # position of the newest written token
        lg, cache = decode_step(params, tokens[:, :, pos].reshape(B * W),
                                pos, cache, cfg)
        lp = torch.log_softmax(lg.float(), dim=-1).reshape(B, W, V)
        lp = torch.where(alive[..., None], lp, frozen)
        cand = (scores[..., None] + lp).reshape(B, W * V)
        scores, idx = stable_topk(cand, W)
        parent, tok = idx // V, idx % V
        tokens = torch.gather(tokens, 1,
                              parent[..., None].expand(B, W, T_out))
        tokens[:, :, pos + 1] = tok.to(prompt.dtype)
        alive = torch.gather(alive, 1, parent) & (tok != eos)
        flat = (parent + base).reshape(B * W)
        cache = [{k: t.index_select(0, flat) for k, t in kv.items()}
                 for kv in cache]
        steps += 1
    # the skipped all-dead steps would have written eos
    fill = torch.arange(T_out, device=dev) > T0 + steps
    tokens = tokens.masked_fill(fill, eos)
    LAST_DECODE_STATS["steps_executed"] = steps
    LAST_DECODE_STATS["max_steps"] = int(max_new_tokens - 1)
    lens = (tokens[:, :, T0:] != eos).sum(-1) + 1
    final = scores / torch.pow((5.0 + lens.float()) / 6.0, alpha)
    order = torch.argsort(-final, dim=1, stable=True)
    tokens = torch.gather(tokens, 1, order[..., None].expand(B, W, T_out))
    return tokens, torch.gather(final, 1, order)


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
