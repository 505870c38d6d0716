"""Single-device attention (counterpart of paddle_tpu/parallel/attention.py).

Only `reference_attention` is ported: the plain full attention that
`forward` takes when no mesh is given (the JAX package's `mesh=None`
branch of `sequence_parallel_attention`). Ring, zigzag and Ulysses
sequence parallelism wait for the parallel slice of the port.
"""

from __future__ import annotations

import math

import torch

from .kernel_utils import NEG_INF

__all__ = ["reference_attention"]


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
