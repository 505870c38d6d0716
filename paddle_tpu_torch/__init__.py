"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA
Hopper (H100).

The JAX package `paddle_tpu` stays the reference; this package mirrors
its module layout (`models/`, `parallel/`, `serving/`, `fluid/`,
`utils/`, `distributed/`) so each module's counterpart is found at the
same relative path. It imports torch and numpy only — never jax, and
nothing from `paddle_tpu` (where a jax-free helper is needed, the port
keeps its own copy).

Every TPU (Pallas) kernel on a ported path becomes a kernel written by
hand for Hopper under `csrc/`, built with nvcc at first use
(`_build.py`) and bound with ctypes. Each kernel's wrapper keeps a
plain PyTorch version of the same function beside it: a CPU tensor
takes the plain version, a CUDA tensor launches the kernel or raises.

Entry points (`init_params`, `params_from_numpy`, the cache
initialisers, `ServingEngine`, `fluid.Executor`) run on CUDA unless the
caller passes ``device="cpu"`` (``fluid.CPUPlace()``); with no GPU and
no explicit CPU request they raise — they never fall back to the CPU
silently.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU (or
    another device) only when the caller names it. Raises when CUDA is
    asked for — explicitly or by default — and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev
