"""Job-level distributed services (counterpart of paddle_tpu/distributed/).

The reference's Go cloud layer: the master's fault-tolerant data-task
queue (go/master/service.go) is `coordinator.Coordinator` (served over
TCP by `CoordinatorServer`, the JAX package's wire protocol), the Go
pserver's CRC-checksummed atomic checkpoints (go/pserver/service.go:
120-226) are `checkpoint` (the JAX package's on-disk format), the
`supervisor` loop composes the two with heartbeat liveness into
restart-from-checkpoint fault tolerance (the role etcd TTL keys and the
cluster controller play in the reference, go/pserver/etcd_client.go),
and the `sentinel` rolls a diverged run back to its known-good step and
quarantines the chunks that poisoned it. `fault_injection` is the fault
injector the serving engine, the legacy trainer and the supervised
workers tick.
"""

from .checkpoint import (AsyncCheckpoint, latest_step, load_checkpoint,
                         resume_or_init, retain, save_checkpoint,
                         save_checkpoint_async, verify_checkpoint,
                         verify_step)
from .coordinator import (Coordinator, CoordinatorServer, MasterClient,
                          RemoteCoordinator, Task)
from .fault_injection import (FaultInjected, FaultInjector, corrupt_file,
                              default_injector, netsplit_active)
from .sentinel import (SENTINEL_EXIT_CODE, DivergenceDetector, SentinelTrip,
                       TrainingSentinel, chunks_consumed, known_good_step,
                       quarantine_chunks, quarantined_chunks)
from .supervisor import Supervisor, WorkerHandle

__all__ = [
    "AsyncCheckpoint",
    "Coordinator",
    "CoordinatorServer",
    "DivergenceDetector",
    "FaultInjected",
    "FaultInjector",
    "MasterClient",
    "RemoteCoordinator",
    "SENTINEL_EXIT_CODE",
    "SentinelTrip",
    "Supervisor",
    "Task",
    "TrainingSentinel",
    "WorkerHandle",
    "chunks_consumed",
    "corrupt_file",
    "default_injector",
    "known_good_step",
    "latest_step",
    "load_checkpoint",
    "netsplit_active",
    "quarantine_chunks",
    "quarantined_chunks",
    "resume_or_init",
    "retain",
    "save_checkpoint",
    "save_checkpoint_async",
    "verify_checkpoint",
    "verify_step",
]
