"""O(1) running statistics for long-lived metric streams (a copy of
`RunningStat` from paddle_tpu/utils/stat.py)."""

from __future__ import annotations

__all__ = ["RunningStat"]


class RunningStat(object):
    """O(1) mean/max accumulator for long-lived metric streams. A
    process that records one value per step / request / batch forever
    must not grow a Python float list without bound — aggregates are
    running sums, not history."""

    __slots__ = ("count", "total", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.max = None

    def append(self, x):
        x = float(x)
        self.count += 1
        self.total += x
        if self.max is None or x > self.max:
            self.max = x

    @property
    def mean(self):
        return self.total / self.count if self.count else None

    def __len__(self):
        return self.count
