"""Utilities (counterpart of paddle_tpu/utils/): the threefry PRNG, the
O(1) running-stat accumulator and the EWMA/hysteresis trip detector."""
