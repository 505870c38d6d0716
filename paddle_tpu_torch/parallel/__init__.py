"""Attention primitives and the paged-attention kernel wrappers
(counterpart of paddle_tpu/parallel/). Only the single-device pieces the
serving slice needs are ported: `reference_attention` and the three
paged-attention wrappers."""

from .attention import reference_attention
from .paged_attention import (paged_decode_attention,
                              paged_prefill_attention,
                              paged_verify_attention)

__all__ = ["reference_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention"]
