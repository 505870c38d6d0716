"""Flash attention: blockwise online-softmax attention that never
materialises the [T, S] score matrix, with a backward that rebuilds
each probability tile from the saved log-sum-exp (counterpart of
paddle_tpu/parallel/flash_attention.py).

`flash_attention` keeps the JAX signature (without `interpret`: a CUDA
kernel has no interpret mode), layout [B, T, H, D] and argument checks.
`block_q`/`block_k` only drive those checks — they are the TPU kernel's
VMEM tiles; the Hopper kernels use their own tiles (128 rows a CTA on
the tensor cores, 64 on the CUDA cores) and mask the ragged edge
themselves, so a length such as 100 or 768 runs unpadded. All three
bf16 passes run on the tensor cores (mma.sync); every f32 pass runs on
the CUDA cores.

The custom VJP is `_FlashAttention`: the forward saves (q, k, v, o,
lse); the backward computes delta = rowsum(g * o) in f32 with torch
ops, then dK/dV, then dQ. On CPU tensors each step runs its plain
PyTorch version below; on CUDA tensors each launches its kernel from
csrc/flash_attention.cu (built by nvcc at first use, bound with ctypes)
and counts the launch in `flash_attention.launches`. There is no
fallback: a CUDA tensor launches or raises.

Numerics (the flash family, unlike `reference_attention`): the scale
multiplies the f32 scores AFTER QK^T, masked scores take the finite
NEG_INF fill with the exact guards, and products round at the TPU
kernel's points — P to v's dtype before P.V, P to g's dtype before
P^T.g, dS to q's dtype before dS^T.Q and to k's dtype before dS.K.
"""

from __future__ import annotations

import ctypes

import torch

from .kernel_utils import (bind_once, causal_fill, count_launch,
                           guarded_exp, on_cpu)

__all__ = ["flash_attention", "flash_forward", "flash_backward",
           "flash_backward_kv", "flash_backward_q", "flash_attention_plain",
           "flash_backward_plain", "flash_backward_kv_plain",
           "flash_backward_q_plain", "shared_bytes"]


def _scores(q, k, scale, causal):
    """f32 scores [B, H, T, S] of [B, T, H, D] inputs, scaled after the
    product, the causal tile mask applied."""
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        s = causal_fill(s, 0, 0, q.shape[1], k.shape[1])
    return s


def flash_attention_plain(q, k, v, scale, causal):
    """The plain PyTorch version of the forward kernel: q [B, T, H, D],
    k/v [B, S, H, D] -> (o [B, T, H, D] in q's dtype, lse [B, H, T]
    f32), one softmax over the whole row instead of the online one."""
    s = _scores(q, k, scale, causal)
    m = s.amax(dim=-1, keepdim=True)
    p = guarded_exp(s, m)
    denom = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())
    o = pv / denom.permute(0, 2, 1, 3)
    lse = (m + torch.log(denom))[..., 0]
    return o.to(q.dtype), lse


def _probs(q, k, lse, scale, causal):
    """Rebuild P = exp(s*scale - lse) [B, H, T, S]; masked taps give
    exp(NEG_INF - lse) = exactly 0."""
    return torch.exp(_scores(q, k, scale, causal) - lse[..., None])


def _ds(q, k, v, g, lse, delta, scale, causal):
    p = _probs(q, k, lse, scale, causal)
    dp = torch.einsum("bthd,bshd->bhts", g.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_backward_kv_plain(q, k, v, g, lse, delta, scale, causal):
    """The plain version of the dK/dV kernel: -> (dk, dv) [B, S, H, D]
    in k's and v's dtypes. `lse` and `delta` are [B, H, T] f32."""
    p, ds = _ds(q, k, v, g, lse, delta, scale, causal)
    dv = torch.einsum("bhts,bthd->bshd", p.to(g.dtype).float(), g.float())
    dk = torch.einsum("bhts,bthd->bshd", ds.to(q.dtype).float(), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_q_plain(q, k, v, g, lse, delta, scale, causal):
    """The plain version of the dQ kernel: -> dq [B, T, H, D]."""
    _p, ds = _ds(q, k, v, g, lse, delta, scale, causal)
    dq = torch.einsum("bhts,bshd->bthd", ds.to(k.dtype).float(), k.float())
    return dq.to(q.dtype)


def _delta(g, o):
    """delta = rowsum(g * o) in f32 -> [B, H, T]."""
    return (g.float() * o.float()).sum(dim=-1).permute(0, 2, 1).contiguous()


def flash_backward_plain(q, k, v, o, lse, g, scale, causal):
    """The plain version of the whole backward (delta, then both
    kernels) -> (dq, dk, dv)."""
    delta = _delta(g, o)
    dk, dv = flash_backward_kv_plain(q, k, v, g, lse, delta, scale, causal)
    dq = flash_backward_q_plain(q, k, v, g, lse, delta, scale, causal)
    return dq, dk, dv


# ---------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------


@bind_once
def _kernels():
    """Build (first call only) and bind csrc/flash_attention.cu."""
    from .. import _build

    lib = _build.load("flash_attention")
    tail = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    fns = {}
    for name, n_ptr in (("flash_forward", 5), ("flash_backward_kv", 8),
                        ("flash_backward_q", 7)):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + tail
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["flash_shared_bytes"] = lib.flash_shared_bytes
    fns["flash_shared_bytes"].argtypes = [ctypes.c_int] * 3
    fns["flash_shared_bytes"].restype = ctypes.c_int
    return fns


def shared_bytes(which, dtype, D):
    """Dynamic shared memory per CTA (bytes) that a launch of kernel
    `which` ("forward", "backward_kv" or "backward_q") requests for
    `dtype` inputs of head width D (builds the library on first use)."""
    n = _kernels()["flash_shared_bytes"](
        ("forward", "backward_kv", "backward_q").index(which),
        int(dtype == torch.bfloat16), D)
    if n < 0:
        raise ValueError("no flash kernel %r at D=%d" % (which, D))
    return n


def _check_rows(q, *rows):
    """lse / delta: f32 [B, H, T] on q's device, contiguous."""
    B, T, H, _ = q.shape
    for t in rows:
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, T) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError("lse and delta must be contiguous float32 "
                             "[B, H, T] = [%d, %d, %d] on %s (got %s %s)"
                             % (B, H, T, q.device, t.dtype,
                                tuple(t.shape)))


def _check(q, k, v, *more):
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("flash attention kernels take float32 or bfloat16 "
                        "(got %s)" % q.dtype)
    for t in (k, v) + more:
        if t.dtype != q.dtype:
            raise TypeError("q, k, v (and g) must share a dtype (got %s and "
                            "%s)" % (q.dtype, t.dtype))
    B, T, H, D = q.shape
    S = k.shape[1]
    if tuple(k.shape) != (B, S, H, D) or v.shape != k.shape:
        raise ValueError("k and v must be [B, S, H, D] = [%d, S, %d, %d] "
                         "(got %s and %s)" % (B, H, D, tuple(k.shape),
                                              tuple(v.shape)))
    epc = 16 // q.element_size()
    if D > 128 or D % epc:
        raise ValueError("kernel takes D <= 128 and a multiple of %d for %s "
                         "(got %d)" % (epc, q.dtype, D))
    for t in (q, k, v) + more:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel inputs must be contiguous and 16-byte "
                             "aligned")
    return B, T, H, D, S


def _call(name, ptrs, q, B, H, T, S, D, scale, causal):
    err = _kernels()[name](
        *ptrs, int(q.dtype == torch.bfloat16), B, H, T, S, D, float(scale),
        int(causal), q.device.index if q.device.index is not None
        else torch.cuda.current_device(),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))
    count_launch(launches, name[len("flash_"):])


def _launch_forward(q, k, v, scale, causal):
    B, T, H, D, S = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty(B, H, T, dtype=torch.float32, device=q.device)
    _call("flash_forward", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), lse.data_ptr()),
          q, B, H, T, S, D, scale, causal)
    return o, lse


def _launch_backward_kv(q, k, v, g, lse, delta, scale, causal):
    B, T, H, D, S = _check(q, k, v, g)
    _check_rows(q, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _call("flash_backward_kv", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                g.data_ptr(), lse.data_ptr(),
                                delta.data_ptr(), dk.data_ptr(),
                                dv.data_ptr()),
          q, B, H, T, S, D, scale, causal)
    return dk, dv


def _launch_backward_q(q, k, v, g, lse, delta, scale, causal):
    B, T, H, D, S = _check(q, k, v, g)
    _check_rows(q, lse, delta)
    dq = torch.empty_like(q)
    _call("flash_backward_q", (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               g.data_ptr(), lse.data_ptr(),
                               delta.data_ptr(), dq.data_ptr()),
          q, B, H, T, S, D, scale, causal)
    return dq


def flash_forward(q, k, v, scale, causal):
    """(o, lse) through the forward kernel on CUDA tensors, through
    `flash_attention_plain` on CPU tensors."""
    if on_cpu("flash attention", q, k, v):
        return flash_attention_plain(q, k, v, scale, causal)
    return _launch_forward(q.contiguous(), k.contiguous(), v.contiguous(),
                           scale, causal)


def flash_backward_kv(q, k, v, g, lse, delta, scale, causal):
    """(dk, dv) through the dK/dV kernel on CUDA tensors, through
    `flash_backward_kv_plain` on CPU tensors."""
    if on_cpu("flash attention", q, k, v, g, lse, delta):
        return flash_backward_kv_plain(q, k, v, g, lse, delta, scale, causal)
    return _launch_backward_kv(q, k, v, g, lse.contiguous(),
                               delta.contiguous(), scale, causal)


def flash_backward_q(q, k, v, g, lse, delta, scale, causal):
    """dq through the dQ kernel on CUDA tensors, through
    `flash_backward_q_plain` on CPU tensors."""
    if on_cpu("flash attention", q, k, v, g, lse, delta):
        return flash_backward_q_plain(q, k, v, g, lse, delta, scale, causal)
    return _launch_backward_q(q, k, v, g, lse.contiguous(),
                              delta.contiguous(), scale, causal)


def flash_backward(q, k, v, o, lse, g, scale, causal):
    """(dq, dk, dv): delta with torch ops, then dK/dV, then dQ."""
    g = g.contiguous()  # autograd may hand back a strided gradient
    delta = _delta(g, o)
    dk, dv = flash_backward_kv(q, k, v, g, lse, delta, scale, causal)
    dq = flash_backward_q(q, k, v, g, lse, delta, scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The `_flash` custom_vjp of the JAX package as an autograd
    Function over [B, T, H, D] tensors."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_forward(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, g, ctx.scale,
                                    ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False, scale=None,
                    block_q: int = 1024, block_k: int = 1024):
    """Blockwise attention for [B, T, H, D] tensors (k/v [B, S, H, D]),
    differentiable through `_FlashAttention`. The block arguments clamp
    to the lengths and halve until they divide them, exactly as the JAX
    package checks them: lengths with no split of at least 8 raise
    ("pad the sequence"), and causal attention needs T == S."""
    B, T, H, D = q.shape
    S = k.shape[1]
    if scale is None:
        scale = D ** -0.5
    block_q = min(block_q, T)
    block_k = min(block_k, S)
    while block_q > 1 and T % block_q:
        block_q //= 2
    while block_k > 1 and S % block_k:
        block_k //= 2
    if block_q < 8 or block_k < 8:
        raise ValueError(
            "sequence lengths (%d, %d) have no usable block split (need "
            "a multiple of 8); pad the sequence" % (T, S))
    if causal and T != S:
        raise ValueError(
            "causal flash attention requires matching q/k lengths "
            "(got %d vs %d)" % (T, S))
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal))


# launch counters: one plain integer per kernel, bumped (under
# count_launch's lock) only where its wrapper launches it (never on the
# CPU's plain version)
launches = {"forward": 0, "backward_kv": 0, "backward_q": 0}
flash_attention.launches = launches
