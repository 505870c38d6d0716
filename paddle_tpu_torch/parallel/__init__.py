"""Attention primitives and the kernel wrappers (counterpart of
paddle_tpu/parallel/). Only the single-device pieces the serving and
training slices need are ported: `reference_attention`,
`sequence_parallel_attention` without a mesh, the flash-attention
wrapper and the three paged-attention wrappers."""

from .attention import reference_attention, sequence_parallel_attention
from .flash_attention import flash_attention
from .paged_attention import (paged_decode_attention,
                              paged_prefill_attention,
                              paged_verify_attention)

__all__ = ["reference_attention", "sequence_parallel_attention",
           "flash_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention"]
