"""Layer functions that build the IR (counterpart of
paddle_tpu/fluid/layers/). An op whose kernel is not ported raises when
the executor reaches it, naming the op."""

from . import control_flow, detection, device, io, nn, ops, tensor
from .control_flow import *  # noqa: F401,F403
from .detection import *  # noqa: F401,F403
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
