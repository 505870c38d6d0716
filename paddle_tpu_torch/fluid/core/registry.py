"""Op kernel registry + run context (counterpart of
paddle_tpu/fluid/core/registry.py).

An "op kernel" is a function of torch tensors: the executor calls the
kernels of a block one after another, eagerly, on its device. Kernels
never see the scope: they map named input tensors to named output
tensors.

Kernel signature::

    fn(ctx: LoweringContext,
       ins: Dict[slot, List[Tensor]],
       attrs: Dict[str, Any]) -> Dict[slot, List[Tensor] | Tensor]
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ...utils import prng

__all__ = ["register_op", "get_kernel", "has_kernel", "LoweringContext",
           "registered_ops", "torch_dtype"]

# the IR's dtype names (program.convert_np_dtype) -> torch dtypes. Unlike
# the JAX package, int64 stays int64: feeds and fills keep their width
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an IR dtype name (or of a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError("unsupported dtype %r" % (name,))


_KERNELS: Dict[str, Callable] = {}


def register_op(op_type: str):
    def deco(fn):
        if op_type in _KERNELS:
            raise ValueError("op %r registered twice" % op_type)
        _KERNELS[op_type] = fn
        return fn

    return deco


def get_kernel(op_type: str) -> Callable:
    try:
        return _KERNELS[op_type]
    except KeyError:
        raise NotImplementedError(
            "op %r has no kernel in paddle_tpu_torch.fluid yet (have %d "
            "ops; ROADMAP Queue A lists the Fluid modules still to port)"
            % (op_type, len(_KERNELS)))


def has_kernel(op_type: str) -> bool:
    return op_type in _KERNELS


def registered_ops() -> List[str]:
    return sorted(_KERNELS)


class LoweringContext(object):
    """Per-run state shared by kernels: the device, the op being run and
    RNG derivation.

    Deterministic RNG: every random op folds a fresh counter into the
    run's base key with the port's threefry (utils/prng.py), exactly as
    the JAX package folds it with jax.random, so a random op of a given
    (program, run) draws the same bits in both packages.
    """

    def __init__(self, block, base_key, device, is_test: bool = False):
        self.block = block
        self._base_key = base_key
        self._rng_counter = 0
        self.device = device
        self.is_test = is_test
        # the op being run (set by lowering.run_op): optimizer kernels
        # read its output names to decide whether to update in place
        self.op = None
        # True while running the bf16 forward region of an AMP program:
        # deny-listed ops (lowering._AMP_F32_OPS) then compute in f32
        self.amp_region = False

    def next_key(self):
        if self._base_key is None:
            raise RuntimeError("this execution was built without an RNG key")
        self._rng_counter += 1
        return prng.fold_in(self._base_key, self._rng_counter)
