"""Attention primitives and the kernel wrappers (counterpart of
paddle_tpu/parallel/). Only the single-device pieces the serving and
training slices need are ported: `reference_attention`,
`sequence_parallel_attention` without a mesh, the flash-attention
wrapper and the three paged-attention wrappers (each taking int8/fp8
pools with per-block scales) with their plain version."""

from .attention import reference_attention, sequence_parallel_attention
from .flash_attention import flash_attention
from .paged_attention import (paged_attention_plain, paged_decode_attention,
                              paged_prefill_attention,
                              paged_verify_attention)

__all__ = ["reference_attention", "sequence_parallel_attention",
           "flash_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention",
           "paged_attention_plain"]
