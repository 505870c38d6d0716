"""Layer functions that build the IR (counterpart of
paddle_tpu/fluid/layers/). `control_flow` and `detection` are not ported
yet (ROADMAP, Queue A); an op whose kernel is not ported raises when the
executor reaches it, naming the op."""

from . import io, nn, ops, tensor
from .io import *  # noqa: F401,F403
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import *  # noqa: F401,F403
