"""DataMetrics: loader-side counters (counterpart of
paddle_tpu/data/metrics.py) in the ServingMetrics running-stat style —
O(1) memory however long the job runs (the same trap
`utils.stat.RunningStat` documents: a loader lives for the whole
training run and records one value per batch).

The headline quantity is the **loader-wait fraction**: of the consumer's
wall time, how much was spent blocked waiting for the next batch (input
bound) vs. doing its own work between `next()` calls (compute bound).
With prefetch overlapping host decode under device compute the fraction
should approach 0. Phase 41 of chip_smoke.py reports it for ResNet-50
fed from shards on the card.
"""

from __future__ import annotations

import time

from ..utils.stat import RunningStat as _RunningStat

__all__ = ["DataMetrics"]


class DataMetrics(object):
    def __init__(self):
        self.batches = 0
        self.records = 0
        self.epochs_completed = 0
        self.wait_s = _RunningStat()        # blocked inside next()
        self.step_s = _RunningStat()        # consumer time between next()s
        self.queue_depth = _RunningStat()   # prefetch queue depth at next()
        self._t0 = None                     # first activity (monotonic)
        self._t1 = None                     # latest activity
        self._last_return = None            # when next() last returned

    # -- recording (called by the loader) -------------------------------
    def batch_delivered(self, n_records: int, wait_seconds: float,
                        queue_depth: int):
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now - wait_seconds
        self._t1 = now
        if self._last_return is not None:
            # consumer-side time since the previous batch was handed out,
            # minus the time we just spent blocked = the consumer's step
            self.step_s.append(
                max(0.0, (now - self._last_return) - wait_seconds))
        self._last_return = now
        self.batches += 1
        self.records += int(n_records)
        self.wait_s.append(wait_seconds)
        self.queue_depth.append(queue_depth)

    def epoch_completed(self):
        self.epochs_completed += 1

    # -- derived --------------------------------------------------------
    @property
    def wall_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return (self._t1 or self._t0) - self._t0

    @property
    def wait_fraction(self):
        """Blocked-on-input share of the consumer's measured time."""
        denom = self.wait_s.total + self.step_s.total
        if denom <= 0:
            return None
        return self.wait_s.total / denom

    def report(self) -> dict:
        def _mean(st):
            return round(st.mean, 6) if st.count else None

        wall = self.wall_s
        wf = self.wait_fraction
        return {
            "batches": self.batches,
            "records": self.records,
            "epochs_completed": self.epochs_completed,
            "batches_per_sec": round(self.batches / wall, 2) if wall else None,
            "records_per_sec": round(self.records / wall, 1) if wall else None,
            "mean_wait_s": _mean(self.wait_s),
            "max_wait_s": round(self.wait_s.max, 6)
            if self.wait_s.count else None,
            "mean_step_s": _mean(self.step_s),
            "wait_fraction": round(wf, 4) if wf is not None else None,
            "mean_queue_depth": _mean(self.queue_depth),
            "wall_s": round(wall, 4),
        }
