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
launches the Hopper kernel csrc/paged_attention.cu (built by nvcc at
first use, bound with ctypes) and counts the launch in its
`launches` attribute; on CPU tensors it runs `paged_attention_plain`,
the plain PyTorch version of the same function, which the CPU tests
hold against the JAX package and chip_smoke.py holds the kernel
against. There is no fallback: a CUDA tensor launches or raises.

The quantized branch (int8/fp8 pools with per-block scales) is not
ported yet: passing `k_scale`/`v_scale` raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .kernel_utils import NEG_INF, guarded_exp, on_cpu

__all__ = ["paged_decode_attention", "paged_verify_attention",
           "paged_prefill_attention", "paged_attention_plain"]


def paged_attention_plain(q, k_pool, v_pool, tables, base, *, scale,
                          scale_in_q):
    """The plain PyTorch version: q [S, R, H, Dh] windows based at
    `base` [S] over tables [S, MAXB] into pools [NB, Bt, H, Dh] ->
    out [S, R, H, Dh] in q's dtype. Gathers each slot's contiguous view
    (-1 entries clamp to block 0), masks by position with the finite
    NEG_INF fill, and takes one softmax in f32 with the exact guards."""
    S, R, H, dh = q.shape
    NB, Bt = k_pool.shape[0], k_pool.shape[1]
    maxb = tables.shape[1]
    L = maxb * Bt
    idx = tables.long().clamp(0, NB - 1)
    kv = k_pool[idx].reshape(S, L, H, dh).float()
    vv = v_pool[idx].reshape(S, L, H, dh).float()
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


@functools.lru_cache(maxsize=None)
def _kernel():
    """Build (first call only) and bind csrc/paged_attention.cu."""
    from .. import _build

    fn = _build.load("paged_attention").paged_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
                   + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k_pool, v_pool, tables, base, *, scale, scale_in_q):
    """Launch the Hopper kernel on the current stream. `base` is an int32
    CUDA tensor [S] or a Python int shared by every slot."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("paged attention kernel takes float32 or bfloat16 "
                        "(got %s)" % q.dtype)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the K/V pools must share a dtype (got %s, "
                        "%s, %s)" % (q.dtype, k_pool.dtype, v_pool.dtype))
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
    epc = 16 // q.element_size()
    if dh > 128 or dh % epc:
        raise ValueError("kernel takes Dh <= 128 and a multiple of %d for "
                         "%s (got %d)" % (epc, q.dtype, dh))
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
    err = _kernel()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        tables.data_ptr(), base_ptr, base_scalar, out.data_ptr(),
        int(q.dtype == torch.bfloat16), S, R, H, dh, NB, Bt,
        tables.shape[1], float(scale), int(scale_in_q),
        q.device.index if q.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("paged_attention kernel launch failed: CUDA "
                           "error %d" % err)
    return out


def _no_quant(k_scale, v_scale):
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV pools (k_scale/v_scale) are not ported yet — "
            "ROADMAP: quantized KV, the kernel's int8/fp8 dequant branch")


def paged_decode_attention(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                           v_scale=None):
    """Batched single-token decode: q [S, H, Dh] at per-slot positions
    `pos` [S] over tables [S, MAXB] into pools [NB, Bt, H, Dh] ->
    [S, H, Dh]. Decode family (scores / sqrt(Dh) after QK^T). A parked
    row (pos >= MAXB*Bt) attends everything its table clamps to —
    garbage nothing reads — but never reads past the table or pool."""
    _no_quant(k_scale, v_scale)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cpu("paged attention", q, k_pool, v_pool, tables, pos):
        return paged_attention_plain(q[:, None], k_pool, v_pool, tables,
                                     pos, scale=scale,
                                     scale_in_q=False)[:, 0]
    out = _launch(q[:, None], k_pool, v_pool, tables, pos, scale=scale,
                  scale_in_q=False)
    paged_decode_attention.launches += 1
    return out[:, 0]


def paged_verify_attention(q, k_pool, v_pool, tables, pos, *, k_scale=None,
                           v_scale=None):
    """K-row verify windows (the spec-decode path): q [S, K, H, Dh], row
    (s, i) at position pos[s] + i attending the slot's cache up to and
    including itself. Chunk family (scale folded into q)."""
    _no_quant(k_scale, v_scale)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cpu("paged attention", q, k_pool, v_pool, tables, pos):
        return paged_attention_plain(q, k_pool, v_pool, tables, pos,
                                     scale=scale, scale_in_q=True)
    out = _launch(q, k_pool, v_pool, tables, pos, scale=scale,
                  scale_in_q=True)
    paged_verify_attention.launches += 1
    return out


def paged_prefill_attention(q, k_pool, v_pool, table_row, start, *,
                            k_scale=None, v_scale=None):
    """Chunked prefill for ONE slot: a [C]-token chunk q [C, H, Dh] whose
    first row sits at position `start` (an int or a 0-d tensor),
    attending cache[0:start] plus the intra-chunk causal prefix through
    `table_row` [MAXB]. Chunk family (scale folded into q)."""
    _no_quant(k_scale, v_scale)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if on_cpu("paged attention", q, k_pool, v_pool, table_row, start):
        base = torch.as_tensor(start, dtype=torch.int64).reshape(1)
        return paged_attention_plain(q[None], k_pool, v_pool,
                                     table_row[None], base, scale=scale,
                                     scale_in_q=True)[0]
    out = _launch(q[None], k_pool, v_pool, table_row.reshape(1, -1), start,
                  scale=scale, scale_in_q=True)
    paged_prefill_attention.launches += 1
    return out[0]


# launch counters: one plain integer per wrapper, bumped only where the
# wrapper launches the kernel (never on the CPU's plain version)
paged_decode_attention.launches = 0
paged_verify_attention.launches = 0
paged_prefill_attention.launches = 0
