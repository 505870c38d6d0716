"""The input pipeline (counterpart of paddle_tpu/data; the reference's
Go-master data plane as a first-class subsystem). Shards, cursors and
the coordinator's wire messages are the JAX package's: either package
reads what the other wrote and resumes where the other stopped.

The reference fed trainers through three cooperating pieces: the
recordio library chunked records on disk, the Go master leased chunks to
trainers with timeout/retry (go/master/service.go), and the C++
DataProvider double-buffered host decode under device compute. This
package is that stack rebuilt with modern loader idioms:

  record_shard  RecordShard chunked shard format (length-prefixed
                records in CRC-checked chunks, atomic-commit writer)
  dataset       ShardedDataset: chunk index + deterministic per-epoch
                shuffles (seed folded with epoch/chunk)
  loader        DataLoader: prefetch threads, ordered reassembly,
                bounded queue, upload to the card overlapped with the
                consumer's step (the one upload path AsyncDeviceFeeder
                also takes), exact mid-epoch
                state_dict resume; CoordinatedChunkSource leases chunks
                from distributed.Coordinator for elastic multi-worker
                sharding with offset-aware re-leases
  metrics       DataMetrics: batches/s, queue depth, loader-wait
                fraction (O(1) running stats)
"""

from .record_shard import (MAGIC, RecordShard, ShardWriter, from_recordio,
                           write_shard)
from .dataset import ChunkRef, ShardedDataset
from .loader import (CoordinatedChunkSource, DataLoader, LeaseLost,
                     LocalChunkSource, default_collate)
from .metrics import DataMetrics

__all__ = [
    "MAGIC",
    "RecordShard",
    "ShardWriter",
    "write_shard",
    "from_recordio",
    "ChunkRef",
    "ShardedDataset",
    "DataLoader",
    "LocalChunkSource",
    "CoordinatedChunkSource",
    "LeaseLost",
    "default_collate",
    "DataMetrics",
]
