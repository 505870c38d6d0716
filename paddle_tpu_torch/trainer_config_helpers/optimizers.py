"""Optimizer settings objects as a module (reference
trainer_config_helpers/optimizers.py)."""

from . import (  # noqa: F401
    AdaDeltaOptimizer,
    AdaGradOptimizer,
    AdamaxOptimizer,
    AdamOptimizer,
    BaseSGDOptimizer,
    DecayedAdaGradOptimizer,
    MomentumOptimizer,
    Optimizer,
    RMSPropOptimizer,
    settings,
)

__all__ = [
    "Optimizer", "BaseSGDOptimizer", "MomentumOptimizer",
    "AdamaxOptimizer", "AdamOptimizer", "AdaGradOptimizer",
    "RMSPropOptimizer", "DecayedAdaGradOptimizer", "AdaDeltaOptimizer",
    "settings",
]
