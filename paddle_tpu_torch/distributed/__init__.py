"""Distributed-systems helpers (counterpart of paddle_tpu/distributed/):
the fault injector the serving engine and the legacy trainer tick, and
the durable checkpoints of `checkpoint` (the JAX package's on-disk
format). The coordinator, supervisor and training sentinel are not
ported yet (ROADMAP Queue A)."""

from .checkpoint import (AsyncCheckpoint, latest_step, load_checkpoint,
                         resume_or_init, retain, save_checkpoint,
                         save_checkpoint_async, verify_checkpoint,
                         verify_step)
from .fault_injection import FaultInjected, FaultInjector

__all__ = [
    "AsyncCheckpoint",
    "FaultInjected",
    "FaultInjector",
    "latest_step",
    "load_checkpoint",
    "resume_or_init",
    "retain",
    "save_checkpoint",
    "save_checkpoint_async",
    "verify_checkpoint",
    "verify_step",
]
