"""Single-device attention (counterpart of paddle_tpu/parallel/attention.py).

`reference_attention` is the plain full attention, and
`sequence_parallel_attention` the entry point `forward` calls, ported
for its single-device branch (the JAX package's `mesh=None` path):
impl="flash" runs the flash kernels, any other impl the plain full
attention. Ring, zigzag and Ulysses sequence parallelism over a mesh
wait for the parallel slice of the port.
"""

from __future__ import annotations

import math

import torch

from .kernel_utils import NEG_INF

__all__ = ["reference_attention", "sequence_parallel_attention"]


def reference_attention(q, k, v, causal: bool = False, scale=None):
    """Plain full attention over [B, T, H, D] tensors: the scale is
    folded into q BEFORE the QK^T matmul and masked scores take the
    finite NEG_INF fill — the numerics family the chunked prefill and
    verify paths share."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bthd,bshd->bhts", q * scale, k)
    if causal:
        S = k.shape[1]
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v)


def sequence_parallel_attention(q, k, v, mesh=None, axis: str = "seq",
                                impl: str = "ring", causal: bool = False,
                                scale=None):
    """Global-view attention entry point over [B, T, H, D] tensors.
    Without a mesh: impl="flash" runs `flash_attention` (the Hopper
    kernels on CUDA tensors), anything else `reference_attention`."""
    if impl == "zigzag" and not causal:
        raise ValueError("impl='zigzag' is causal-only")
    if mesh is not None:
        raise NotImplementedError(
            "mesh (sequence-parallel) attention is not ported yet — "
            "ROADMAP: the parallel slice")
    if impl == "flash":
        from .flash_attention import flash_attention

        return flash_attention(q, k, v, causal=causal, scale=scale)
    return reference_attention(q, k, v, causal=causal, scale=scale)
