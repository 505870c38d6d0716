"""Pooling type objects as a module (reference
trainer_config_helpers/poolings.py)."""

from . import (  # noqa: F401
    AvgPooling,
    BasePoolingType,
    CudnnAvgInclPadPooling,
    CudnnAvgPooling,
    CudnnMaxPooling,
    MaxPooling,
    MaxWithMaskPooling,
    SquareRootNPooling,
    SumPooling,
)

__all__ = [
    "BasePoolingType", "MaxPooling", "AvgPooling", "MaxWithMaskPooling",
    "CudnnMaxPooling", "CudnnAvgPooling", "CudnnAvgInclPadPooling",
    "SumPooling", "SquareRootNPooling",
]
