"""Numerics shared by the port's attention kernels and their plain
versions (counterpart of paddle_tpu/parallel/kernel_utils.py).

`NEG_INF` is the finite mask fill the softmax guards compare against
EXACTLY: a masked score must contribute exactly 0 and a fully-masked
tile must leave a running (max, sum, acc) state unchanged, so the
guards test `s <= NEG_INF` and `m_prev <= NEG_INF` instead of relying
on `exp(-inf)`. The CUDA kernel (csrc/paged_attention.cu) hard-codes
the same value and the same two guards.
"""

from __future__ import annotations

import torch

__all__ = ["NEG_INF", "guarded_exp"]

# Finite -inf stand-in for score masking. Finite on purpose: the
# online-softmax no-op guards (`p = where(s <= NEG_INF, 0, p)`,
# `alpha = where(m_prev <= NEG_INF, 0, alpha)`) need exact comparisons,
# and exp(-1e30 - m) underflows to exactly 0.0 for any finite m.
NEG_INF = -1e30


def guarded_exp(x, m):
    """exp(x - m) with the exact no-op guard: entries at or below
    NEG_INF (masked scores, or a never-updated running max) give exactly
    0 instead of whatever exp of a huge negative rounds to."""
    e = torch.exp(x - m)
    return torch.where(x <= NEG_INF, torch.zeros_like(e), e)
