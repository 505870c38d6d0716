"""Distributed-systems helpers (counterpart of paddle_tpu/distributed/):
only the fault injector the serving engine ticks is ported so far."""
