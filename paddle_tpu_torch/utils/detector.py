"""EWMA/hysteresis trip detector (a copy of
paddle_tpu/utils/detector.py): the verdict machine the serving
sentinel runs over the per-step max-|logit| signal.

  observe(value, aux_finite=...) -> "ok" | "nonfinite" | "spike"

    nonfinite  the value (or any auxiliary signal) is non-finite:
               trips IMMEDIATELY
    spike      |value| > spike_factor * EWMA(|value|) for `hysteresis`
               consecutive observations (after `warmup` healthy ones
               seed the EWMA)

Suspect observations never update the EWMA (a slow-motion blowup must
not drag its own baseline up); a sub-hysteresis excursion resets the
streak and decays normally.
"""

from __future__ import annotations

import math

__all__ = ["TripDetector"]


class TripDetector(object):
    """Hard trip on non-finite signals, soft trip on a sustained spike
    vs the signal's own EWMA. Single-threaded by design (called once
    per step from whatever loop owns it — trainer step loop, serving
    scheduler); fields are domain-confined, not locked."""

    def __init__(self, spike_factor: float = 4.0, hysteresis: int = 2,
                 ewma_alpha: float = 0.2, warmup: int = 3):
        if spike_factor <= 1.0:
            raise ValueError("spike_factor must be > 1")
        if hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError("ewma_alpha must be in (0, 1]")
        self.spike_factor = float(spike_factor)
        self.hysteresis = int(hysteresis)
        self.ewma_alpha = float(ewma_alpha)
        self.warmup = int(warmup)
        self._ewma = None      # guarded-by: owner
        self._seen = 0         # guarded-by: owner
        self._streak = 0       # guarded-by: owner

    @property
    def ewma(self):
        return self._ewma

    @property
    def suspect(self) -> bool:
        """True while a spike streak is open (recent observations were
        held out of the EWMA): the divergence may already have begun."""
        return self._streak > 0

    def observe(self, value, aux_finite=None) -> str:
        """One observation. `aux_finite` is an optional second signal
        checked ONLY for finiteness (the training side's grad norm)."""
        value = float(value)
        if not math.isfinite(value) or (
                aux_finite is not None
                and not math.isfinite(float(aux_finite))):
            self._streak = 0  # a recovery restarts the soft window clean
            return "nonfinite"
        if (self._ewma is not None and self._seen >= self.warmup
                and abs(value) > self.spike_factor * max(abs(self._ewma),
                                                         1e-12)):
            self._streak += 1
            if self._streak >= self.hysteresis:
                self._streak = 0
                return "spike"
            return "ok"  # suspect, but within hysteresis: hold the EWMA
        self._streak = 0
        self._ewma = (value if self._ewma is None
                      else (1.0 - self.ewma_alpha) * self._ewma
                      + self.ewma_alpha * value)
        self._seen += 1
        return "ok"

    def state_dict(self) -> dict:
        return {"ewma": self._ewma, "seen": self._seen,
                "streak": self._streak}

    def load_state_dict(self, state: dict):
        self._ewma = state.get("ewma")
        self._seen = int(state.get("seen", 0))
        self._streak = int(state.get("streak", 0))
