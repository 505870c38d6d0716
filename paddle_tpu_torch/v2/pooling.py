"""paddle.v2.pooling (reference python/paddle/v2/pooling.py): pooling
type markers, shared with the config DSL."""

from ..trainer_config_helpers import (  # noqa: F401
    AvgPooling,
    BasePoolingType,
    CudnnAvgPooling,
    CudnnMaxPooling,
    MaxPooling,
    MaxWithMaskPooling,
    SquareRootNPooling,
    SumPooling,
)

Max = MaxPooling
Avg = AvgPooling
Sum = SumPooling
SquareRootN = SquareRootNPooling

__all__ = ["Max", "Avg", "Sum", "SquareRootN", "MaxPooling",
           "AvgPooling", "SumPooling", "SquareRootNPooling",
           "BasePoolingType", "CudnnAvgPooling", "CudnnMaxPooling",
           "MaxWithMaskPooling"]
