"""Paged attention: attend THROUGH per-slot block tables into a KV block
pool (counterpart of paddle_tpu/parallel/paged_attention.py).

The pool is [NB, Bt, H, Dh] per layer and each slot's block table
[S, MAXB] maps logical depth to physical blocks (PagedAttention, Kwon
et al., SOSP '23). Row r of a window whose first row sits at `base`
attends depths <= base + r, so unwritten depths — and the rows a `-1`
(unallocated) table entry surfaces after its clamp to block 0 — are
excluded by position and contribute exactly 0: a slot whose table tail
is -1 gives output bit-identical to the same slot over a full table.

Two numerics families, as in the JAX package:
  * decode — scores scaled AFTER QK^T (`_cached_attention`'s family);
  * verify / prefill chunk — the scale folded into q BEFORE the matmul
    (`reference_attention`'s family).

Each wrapper keeps the JAX argument order and layouts (without
`interpret`: a CUDA kernel has no interpret mode). On a CUDA tensor it
launches the Hopper kernels of csrc/paged_attention.cu (built by nvcc at
first use, bound with ctypes) and counts the call in the module's
`launches` dict (keys "decode", "verify", "prefill"; launches over
quantized pools also in `quant_launches["int8" | "fp8"]`); on CPU
tensors it runs `paged_attention_plain`, the plain PyTorch version of
the same function, which the CPU tests hold against the JAX package and
chip_smoke.py holds the kernels against. There is no fallback: a CUDA
tensor launches or raises.

q in bf16 and in f32 runs the split-context kernel: the table walk is
cut into `split_parts(S, R, H, Bt, MAXB)` partitions of contiguous table
entries (set by the shapes alone), each CTA writes its partition's (m,
l, acc) to a workspace, and a second kernel merges them in partition
order. `paged_attention_split_plain` is the plain version of exactly
that computation; the CPU tests hold it against `paged_attention_plain`
and the JAX package.

Quantized pools: with `k_scale`/`v_scale` [NB, H] f32 (both or
neither) the pools hold int8 or float8_e4m3fn codes, and each staged
K/V row is dequantized as code * scale[physical block, head] in f32
before it meets q — in the kernel's shared memory, or in the plain
version's gathered view. No dequantized pool ever exists in device
memory on the kernel path.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .kernel_utils import (NEG_INF, bind_once, count_launch, guarded_exp,
                           on_cpu, raw_bytes)

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "paged_prefill_attention", "paged_attention_plain",
           "paged_attention_split_plain", "paged_view", "split_parts",
           "split_shared_bytes"]


def _check_scales(k_scale, v_scale):
    """True for a quantized pool; raises when only one scale is given."""
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("pass both k_scale and v_scale, or neither")
    return quant


def paged_view(pool, tables, scale=None):
    """Gather a contiguous per-slot view [..., MAXB*Bt, H, Dh] out of the
    pool [NB, Bt, H, Dh] through tables [..., MAXB], in the pool's dtype;
    with `scale` [NB, H] the pool holds codes and the view is f32 codes
    times each block's per-head scale, broadcast over its Bt rows — the
    numerics the kernel applies while staging. -1 entries clamp to block
    0 (scale included); every caller masks them by position. fp8 codes
    are gathered through the pool's uint8 view."""
    NB, Bt, H, dh = pool.shape
    idx = tables.long().clamp(0, NB - 1)
    rows = raw_bytes(pool)[idx].view(pool.dtype).reshape(
        tuple(tables.shape[:-1]) + (tables.shape[-1] * Bt, H, dh))
    if scale is None:
        return rows
    return rows.float() * scale[idx].repeat_interleave(Bt, dim=-2)[..., None]


def paged_attention_plain(q, k_pool, v_pool, tables, base, *, scale,
                          scale_in_q, k_scale=None, v_scale=None):
    """The plain PyTorch version: q [S, R, H, Dh] windows based at
    `base` [S] over tables [S, MAXB] into pools [NB, Bt, H, Dh] ->
    out [S, R, H, Dh] in q's dtype. Gathers each slot's contiguous view
    (-1 entries clamp to block 0; quantized pools dequantize with the
    clamped entry's scales), masks by position with the finite NEG_INF
    fill, and takes one softmax in f32 with the exact guards."""
    _check_scales(k_scale, v_scale)
    S, R = q.shape[0], q.shape[1]
    L = tables.shape[1] * k_pool.shape[1]
    kv = paged_view(k_pool, tables, k_scale).float()
    vv = paged_view(v_pool, tables, v_scale).float()
    qf = q.float()
    if scale_in_q:
        qf = qf * scale
    s = torch.einsum("srhd,slhd->shrl", qf, kv)
    if not scale_in_q:
        s = s * scale
    rowpos = base.long().reshape(S, 1) + torch.arange(R, device=q.device)
    depth = torch.arange(L, device=q.device)
    masked = depth.view(1, 1, L) > rowpos.view(S, R, 1)  # [S, R, L]
    s = s.masked_fill(masked[:, None], NEG_INF)
    p = guarded_exp(s, s.amax(dim=-1, keepdim=True))
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("shrl,slhd->srhd", p, vv) / denom.permute(0, 2, 1, 3)
    return o.to(q.dtype)


def paged_attention_split_plain(q, k_pool, v_pool, tables, base, *, scale,
                                scale_in_q, parts, k_scale=None,
                                v_scale=None):
    """The plain version of the split-context kernel: the function of
    `paged_attention_plain`, computed as the kernel computes it. The
    table's MAXB entries are cut into partitions of E = ceil(MAXB /
    parts) entries (partition p takes entries [p*E, (p+1)*E); trailing
    ones may be empty); each gives (m, l, acc) in f32 from its own
    masked softmax (m = NEG_INF, l = 0, acc = 0 when no depth of it is
    attended), and the partitions merge in order with weights
    exp(m_p - max m), exactly 0 for m_p <= NEG_INF: out = sum w*acc /
    max(sum w*l, 1e-30) in q's dtype."""
    _check_scales(k_scale, v_scale)
    S, R = q.shape[0], q.shape[1]
    MAXB, Bt = tables.shape[1], k_pool.shape[1]
    L = MAXB * Bt
    kv = paged_view(k_pool, tables, k_scale).float()
    vv = paged_view(v_pool, tables, v_scale).float()
    qf = q.float()
    if scale_in_q:
        qf = qf * scale
    s = torch.einsum("srhd,slhd->shrl", qf, kv)
    if not scale_in_q:
        s = s * scale
    rowpos = base.long().reshape(S, 1) + torch.arange(R, device=q.device)
    depth = torch.arange(L, device=q.device)
    masked = depth.view(1, 1, L) > rowpos.view(S, R, 1)  # [S, R, L]
    s = s.masked_fill(masked[:, None], NEG_INF)
    span = -(-MAXB // parts) * Bt  # tokens a partition takes
    ms, ls, accs = [], [], []
    for t0 in range(0, L, span):
        sp = s[..., t0:t0 + span]
        m = sp.amax(dim=-1, keepdim=True)  # NEG_INF when all masked
        p = guarded_exp(sp, m)
        ms.append(m)
        ls.append(p.sum(dim=-1, keepdim=True))
        accs.append(torch.einsum("shrl,slhd->shrd", p,
                                 vv[:, t0:t0 + span]))
    top = torch.stack(ms).amax(dim=0)
    l_sum = torch.zeros_like(top)
    acc = torch.zeros_like(accs[0])
    for m, l_p, a in zip(ms, ls, accs):  # partition order
        w = guarded_exp(m, top)
        l_sum = l_sum + w * l_p
        acc = acc + w * a
    o = acc / l_sum.clamp_min(1e-30)
    return o.permute(0, 2, 1, 3).to(q.dtype)


@bind_once
def _kernels():
    """Build (first call only) and bind csrc/paged_attention.cu."""
    from .. import _build

    lib = _build.load("paged_attention")
    tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]
    head = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]
    fns = {"split": lib.paged_attention_split_launch,
           "parts": lib.paged_split_parts,
           "shared": lib.paged_split_shared_bytes}
    fns["split"].argtypes = head + [ctypes.c_void_p] + [ctypes.c_int] * 3 \
        + tail
    fns["parts"].argtypes = [ctypes.c_int] * 5
    fns["shared"].argtypes = [ctypes.c_int] * 4
    for fn in fns.values():
        fn.restype = ctypes.c_int
    return fns


@functools.lru_cache(maxsize=None)
def split_parts(S, R, H, Bt, MAXB):
    """Context partitions the split kernel takes for S slots of R rows
    over H heads and [S, MAXB] tables of Bt-token blocks (the shapes
    alone set it; builds the library on first use)."""
    n = _kernels()["parts"](S, R, H, Bt, MAXB)
    if n < 1:
        raise ValueError("no split for shapes %s" % ((S, R, H, Bt, MAXB),))
    return n


# pool storage the kernel takes beside q's own dtype: its code in the C
# interface (0 = q's dtype)
_POOL_CODES = {torch.int8: 1, torch.float8_e4m3fn: 2}


def split_shared_bytes(pool_dtype, R, Dh):
    """Dynamic shared memory per CTA (bytes) that the split kernel
    requests for R window rows of head width Dh over pools of
    `pool_dtype` (bfloat16, float32, int8 or float8_e4m3fn; builds the
    library on first use)."""
    if pool_dtype not in (torch.bfloat16, torch.float32) and \
            pool_dtype not in _POOL_CODES:
        raise TypeError("no split kernel for pools of %s" % pool_dtype)
    n = _kernels()["shared"](int(pool_dtype != torch.float32),
                             _POOL_CODES.get(pool_dtype, 0), R, Dh)
    if n < 0:
        raise ValueError("no split kernel for R=%d, Dh=%d" % (R, Dh))
    return n


def _launch(q, k_pool, v_pool, tables, base, *, scale, scale_in_q,
            k_scale=None, v_scale=None):
    """Launch the Hopper kernels on the current stream: q (bf16 or f32)
    through the split kernel and, with more than one partition, the
    merge, with a workspace allocated here. `base` is an int32 CUDA tensor
    [S] or a Python int shared by every slot. Pools are q's dtype, or
    int8 / float8_e4m3fn codes with f32 scales [NB, H]."""
    quant = _check_scales(k_scale, v_scale)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("paged attention kernel takes float32 or bfloat16 "
                        "(got %s)" % q.dtype)
    if v_pool.dtype != k_pool.dtype:
        raise TypeError("the K and V pools must share a dtype (got %s, %s)"
                        % (k_pool.dtype, v_pool.dtype))
    if quant != (k_pool.dtype in _POOL_CODES) or (
            not quant and k_pool.dtype != q.dtype):
        raise TypeError("pools of %s with q of %s%s: the kernel takes pools "
                        "of q's dtype without scales, or int8 / "
                        "float8_e4m3fn pools with k_scale and v_scale"
                        % (k_pool.dtype, q.dtype,
                           " and scales" if quant else ""))
    S, R, H, dh = q.shape
    NB, Bt = k_pool.shape[0], k_pool.shape[1]
    if tuple(k_pool.shape) != (NB, Bt, H, dh) or v_pool.shape != k_pool.shape:
        raise ValueError("pools must be [NB, Bt, H, Dh] = [%d, %d, %d, %d] "
                         "(got %s and %s)" % (NB, Bt, H, dh,
                                              tuple(k_pool.shape),
                                              tuple(v_pool.shape)))
    if tables.dim() != 2 or tables.shape[0] != S:
        raise ValueError("tables must be [S=%d, MAXB] (got %s)"
                         % (S, tuple(tables.shape)))
    epc = 16 // k_pool.element_size()  # elements per 16-byte load
    if dh > 128 or dh % epc:
        raise ValueError("kernel takes Dh <= 128 and a multiple of %d for "
                         "%s pools (got %d)" % (epc, k_pool.dtype, dh))
    if quant:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if (t.dtype != torch.float32 or tuple(t.shape) != (NB, H)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError("%s must be a contiguous float32 [NB, H] "
                                 "= [%d, %d] tensor on %s" % (
                                     name, NB, H, q.device))
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if not t.is_contiguous():
            raise ValueError("%s must be contiguous" % name)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError("%s must be 16-byte aligned" % name)
    tables = tables.to(torch.int32).contiguous()
    if isinstance(base, torch.Tensor):
        base = base.to(torch.int32).reshape(S).contiguous()
        base_ptr, base_scalar = base.data_ptr(), 0
    else:
        base_ptr, base_scalar = None, int(base)
    out = torch.empty_like(q)
    MAXB = tables.shape[1]
    head = (q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            k_scale.data_ptr() if quant else None,
            v_scale.data_ptr() if quant else None,
            tables.data_ptr(), base_ptr, base_scalar, out.data_ptr())
    tail = (S, R, H, dh, NB, Bt, MAXB, float(scale), int(scale_in_q),
            q.device.index if q.device.index is not None
            else torch.cuda.current_device(),
            torch.cuda.current_stream(q.device).cuda_stream)
    pool = _POOL_CODES.get(k_pool.dtype, 0)
    parts = split_parts(S, R, H, Bt, MAXB) if S * R * H else 1
    ws = (torch.empty(S * R * H * parts * (dh + 2), dtype=torch.float32,
                      device=q.device) if parts > 1 else None)
    err = _kernels()["split"](*head, None if ws is None else ws.data_ptr(),
                              parts, int(q.dtype == torch.bfloat16), pool,
                              *tail)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           "error %d" % err)
    return out


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                           v_scale=None):
    """Batched single-token decode: q [S, H, Dh] at per-slot positions
    `pos` [S] over tables [S, MAXB] into pools [NB, Bt, H, Dh] ->
    [S, H, Dh]. Decode family (scores / sqrt(Dh) after QK^T). A parked
    row (pos >= MAXB*Bt) attends everything its table clamps to —
    garbage nothing reads — but never reads past the table or pool.
    `k_scale`/`v_scale` [NB, H] dequantize int8/fp8 pools."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if on_cpu("paged attention", q, k_pool, v_pool, tables, pos, k_scale,
              v_scale):
        return paged_attention_plain(q[:, None], k_pool, v_pool, tables,
                                     pos, scale=scale, scale_in_q=False,
                                     **sc)[:, 0]
    out = _launch(q[:, None], k_pool, v_pool, tables, pos, scale=scale,
                  scale_in_q=False, **sc)
    _count("decode", k_pool)
    return out[:, 0]


def paged_verify_attention(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                           v_scale=None):
    """K-row verify windows (the spec-decode path): q [S, K, H, Dh], row
    (s, i) at position pos[s] + i attending the slot's cache up to and
    including itself. Chunk family (scale folded into q)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if on_cpu("paged attention", q, k_pool, v_pool, tables, pos, k_scale,
              v_scale):
        return paged_attention_plain(q, k_pool, v_pool, tables, pos,
                                     scale=scale, scale_in_q=True, **sc)
    out = _launch(q, k_pool, v_pool, tables, pos, scale=scale,
                  scale_in_q=True, **sc)
    _count("verify", k_pool)
    return out


def paged_prefill_attention(q, k_pool, v_pool, table_row, start, *,
                            k_scale=None, v_scale=None):
    """Chunked prefill for ONE slot: a [C]-token chunk q [C, H, Dh] whose
    first row sits at position `start` (an int or a 0-d tensor),
    attending cache[0:start] plus the intra-chunk causal prefix through
    `table_row` [MAXB]. Chunk family (scale folded into q)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    sc = dict(k_scale=k_scale, v_scale=v_scale)
    if on_cpu("paged attention", q, k_pool, v_pool, table_row, start,
              k_scale, v_scale):
        base = torch.as_tensor(start, dtype=torch.int64).reshape(1)
        return paged_attention_plain(q[None], k_pool, v_pool,
                                     table_row[None], base, scale=scale,
                                     scale_in_q=True, **sc)[0]
    out = _launch(q[None], k_pool, v_pool, table_row.reshape(1, -1), start,
                  scale=scale, scale_in_q=True, **sc)
    _count("prefill", k_pool)
    return out[0]


# launch counters: one plain integer per wrapper, bumped (under
# count_launch's lock) only where the wrapper launches the kernel (never
# on the CPU's plain version); the launches over int8 and float8_e4m3fn
# pools count again in `quant_launches`, by pool
launches = {"decode": 0, "verify": 0, "prefill": 0}
quant_launches = {kvq: {"decode": 0, "verify": 0, "prefill": 0}
                  for kvq in ("int8", "fp8")}
_QUANT_POOLS = {torch.int8: "int8", torch.float8_e4m3fn: "fp8"}


def _count(which, k_pool):
    """Count one launch of the `which` wrapper, and apart by pool where
    the pool is quantized."""
    count_launch(launches, which)
    if k_pool.dtype in _QUANT_POOLS:
        count_launch(quant_launches[_QUANT_POOLS[k_pool.dtype]], which)
