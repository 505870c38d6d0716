"""Serving integrity sentinel (counterpart of
paddle_tpu/serving/integrity.py): `IntegrityError` and the per-engine
`ServingSentinel`.

Every decode step and every final prefill chunk also computes a
per-slot non-finite TRAP over its logits (`transformer.logits_trap`:
logits plus the softmax denominator) and a max-|logit| scalar
(`transformer.logit_amax`). A tripped slot becomes an `IntegrityError`
instead of an emitted token; with `spike_factor` set, the scalar feeds
the shared EWMA/hysteresis `TripDetector` to catch wrong-but-finite
magnitude excursions. KV block fingerprints and the fleet's canaries
are not ported yet.
"""

from __future__ import annotations

from typing import Optional

from ..utils.detector import TripDetector

__all__ = ["IntegrityError", "ServingSentinel"]


class IntegrityError(RuntimeError):
    """A serving engine produced evidence of silent corruption. `kind`
    is "trap" | "spike" (the fleet adds "fingerprint" | "canary");
    `replica` names the tripped replica when known."""

    def __init__(self, msg: str, kind: str = "trap", replica=None):
        super().__init__(msg)
        self.kind = kind
        self.replica = replica


class ServingSentinel(object):
    """Folds one step's trap flag and max-|logit| scalar into a verdict:

    observe(trap_any, scale) -> "ok" | "trap" | "spike"

    The trap is a hard verdict; the scale feeds the spike detector only
    when `spike_factor` is set (magnitudes vary honestly across
    workloads, so the soft detector is opt-in)."""

    def __init__(self, spike_factor: Optional[float] = None,
                 hysteresis: int = 2, warmup: int = 8):
        self.detector = (
            TripDetector(spike_factor=float(spike_factor),
                         hysteresis=hysteresis, warmup=warmup)
            if spike_factor is not None else None)  # guarded-by: scheduler
        self.trips = 0  # guarded-by: scheduler

    def observe(self, trap_any: bool, scale: float) -> str:
        if trap_any:
            self.trips += 1
            return "trap"
        if self.detector is not None and scale > 0.0:
            if self.detector.observe(scale) != "ok":
                # "nonfinite" on the scale means the trap already fired
                # upstream in practice; fold both into the spike verdict
                self.trips += 1
                return "spike"
        return "ok"
