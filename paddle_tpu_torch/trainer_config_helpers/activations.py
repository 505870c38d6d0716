"""Activation objects, importable as a module the way reference configs do
(reference python/paddle/trainer_config_helpers/activations.py). The
classes live in the package __init__; this module re-exports them."""

from . import (  # noqa: F401
    AbsActivation,
    BaseActivation,
    BReluActivation,
    ExpActivation,
    IdentityActivation,
    LinearActivation,
    LogActivation,
    ReciprocalActivation,
    ReluActivation,
    SequenceSoftmaxActivation,
    SigmoidActivation,
    SoftmaxActivation,
    SoftReluActivation,
    SoftSignActivation,
    SqrtActivation,
    SquareActivation,
    STanhActivation,
    TanhActivation,
)

__all__ = [
    "TanhActivation", "SigmoidActivation", "SoftmaxActivation",
    "IdentityActivation", "LinearActivation", "SequenceSoftmaxActivation",
    "ExpActivation", "ReluActivation", "BReluActivation",
    "SoftReluActivation", "STanhActivation", "AbsActivation",
    "SquareActivation", "BaseActivation", "LogActivation",
    "SqrtActivation", "ReciprocalActivation", "SoftSignActivation",
]
