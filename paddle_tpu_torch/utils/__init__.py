"""Utilities (counterpart of paddle_tpu/utils/): the threefry PRNG, the
O(1) running-stat accumulator, the EWMA/hysteresis trip detector and
the process flags (`FLAGS`)."""

from .flags import FLAGS  # noqa: F401
