"""Core of the port's Fluid framework: IR, op kernels, execution
(counterpart of paddle_tpu/fluid/core/).

program.py (the IR, a copy of the JAX package's), registry.py +
kernels_*.py (the op set as torch functions), lowering.py (a block's ops
run eagerly on the executor's device, autograd for the backward).
The kernel modules of CRF, sampled losses and detection are not ported
yet (ROADMAP, Queue A).
"""

import torch

from .program import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
    default_startup_program,
    grad_var_name,
    program_guard,
    switch_main_program,
    switch_startup_program,
    unique_name,
)
from .registry import LoweringContext, get_kernel, has_kernel, register_op, registered_ops

# importing the kernel modules populates the registry
from . import kernels_math  # noqa: F401
from . import kernels_nn  # noqa: F401
from . import kernels_tensor  # noqa: F401
from . import kernels_optim  # noqa: F401
from . import kernels_sequence  # noqa: F401
from . import kernels_rnn  # noqa: F401
from . import kernels_control  # noqa: F401
from . import kernels_ctc  # noqa: F401
from .lowering import AUTODIFF_OP, run_block
from ... import resolve_device


class CPUPlace(object):
    """The host (reference platform/place.h:53)."""

    def __repr__(self):
        return "CPUPlace"

    def __eq__(self, other):
        return type(self) is type(other) and vars(self) == vars(other)

    def __hash__(self):
        return hash((type(self), tuple(sorted(vars(self).items()))))


class CUDAPlace(CPUPlace):
    """CUDA device `device_id`."""

    def __init__(self, device_id: int = 0):
        self.device_id = device_id

    def __repr__(self):
        return "CUDAPlace(%d)" % self.device_id


class TPUPlace(CUDAPlace):
    """The JAX package's name for "the accelerator", kept so its scripts
    run unchanged: here it is CUDA device `device_id`."""

    def __repr__(self):
        return "TPUPlace(%d)->CUDA" % self.device_id


def place_device(place=None) -> torch.device:
    """The torch device of a place. No place means the card (raising
    where there is none, through `resolve_device`); `CPUPlace()` is the
    only way to the CPU."""
    if place is None:
        place = CUDAPlace(torch.cuda.current_device()
                          if torch.cuda.is_available() else 0)
    if isinstance(place, CUDAPlace):
        return resolve_device("cuda:%d" % place.device_id)
    if isinstance(place, CPUPlace):
        return torch.device("cpu")
    raise TypeError("not a place: %r" % (place,))
