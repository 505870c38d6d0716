"""Attention primitives, the kernel wrappers and the mesh (counterpart
of paddle_tpu/parallel/). Ported: `reference_attention` and
sequence-parallel attention over a mesh's 'seq' axis (ring, zigzag and
Ulysses, the flash kernels per shard), the flash-attention wrapper and
the three paged-attention wrappers (each taking int8/fp8 pools with
per-block scales) with their plain version; the mesh over
torch.distributed (mesh.py: `make_mesh`, `make_hybrid_mesh`,
`shard_parameter`, `shard_parameters_fsdp`, `DistributedContext`), its
collectives (collectives.py, with all_to_all and the ring shift), local
SGD (async_sgd.py), row-sharded embedding tables (embedding.py), the
Switch-MoE layer with expert parallelism (moe.py) and the GPipe
pipeline (pipeline.py). The Fluid executor runs programs on a mesh
(fluid/executor.py)."""

from .attention import (reference_attention, ring_attention,
                        sequence_parallel_attention, ulysses_attention,
                        zigzag_permutation, zigzag_ring_attention)
from .embedding import ShardedEmbedding, sharded_lookup
from .flash_attention import flash_attention
from .mesh import (DistributedContext, PartitionSpec, data_parallel_axes,
                   data_sharding, get_default_mesh, make_hybrid_mesh,
                   make_mesh, replicated, set_default_mesh, shard_parameter,
                   shard_parameters_fsdp, spans_processes)
from .moe import expert_parallel_moe, moe_capacity, reference_moe
from .paged_attention import (paged_attention_plain, paged_decode_attention,
                              paged_prefill_attention,
                              paged_verify_attention)
from .pipeline import gpipe_pipeline, reference_pipeline

__all__ = ["reference_attention", "sequence_parallel_attention",
           "ring_attention", "ulysses_attention", "zigzag_ring_attention",
           "zigzag_permutation", "expert_parallel_moe", "moe_capacity",
           "reference_moe", "gpipe_pipeline", "reference_pipeline",
           "flash_attention", "paged_decode_attention",
           "paged_verify_attention", "paged_prefill_attention",
           "paged_attention_plain", "make_mesh", "make_hybrid_mesh",
           "get_default_mesh", "set_default_mesh", "shard_parameter",
           "shard_parameters_fsdp", "data_sharding", "replicated",
           "data_parallel_axes", "spans_processes", "PartitionSpec",
           "DistributedContext", "sharded_lookup", "ShardedEmbedding"]
