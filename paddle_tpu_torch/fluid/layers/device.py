"""Device-placement layers (counterpart of paddle_tpu/fluid/layers/
device.py; reference python/paddle/v2/fluid/layers/device.py).
`get_places` itself lives with the ParallelDo machinery in
control_flow.py; this module keeps the reference's module path
importable."""

from .control_flow import get_places

__all__ = ["get_places"]
