"""Scoped timers aggregated in a global StatSet (reference
paddle/utils/Stat.h:63 StatSet, :230 REGISTER_TIMER — RAII timers used
throughout the reference hot loop, TrainerInternal.cpp:94-152), and the
O(1) running statistics of long-lived metric streams.

The timers read the host's wall clock and add no device sync: on the
card a `timer` around a call measures the host's dispatch of the work it
launches, not the device's time to run it. Bracket the work with CUDA
events, or end it in a sync inside the timer, to time the device."""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

__all__ = ["StatSet", "global_stats", "timer", "RunningStat"]


class _Stat(object):
    __slots__ = ("total", "count", "max")

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.max = 0.0

    def add(self, dt):
        self.total += dt
        self.count += 1
        self.max = max(self.max, dt)


class StatSet(object):
    def __init__(self, name="global"):
        self.name = name
        self._stats: Dict[str, _Stat] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def timer(self, name):
        t0 = time.time()
        try:
            yield
        finally:
            dt = time.time() - t0
            with self._lock:
                self._stats.setdefault(name, _Stat()).add(dt)

    def reset(self):
        with self._lock:
            self._stats.clear()

    def summary(self) -> str:
        lines = ["======= StatSet: [%s] =======" % self.name]
        lines.append(
            "%-30s %10s %10s %12s %10s"
            % ("name", "calls", "total(ms)", "avg(ms)", "max(ms)")
        )
        with self._lock:
            for name in sorted(self._stats):
                s = self._stats[name]
                lines.append(
                    "%-30s %10d %10.2f %12.3f %10.2f"
                    % (
                        name, s.count, s.total * 1e3,
                        s.total / max(s.count, 1) * 1e3, s.max * 1e3,
                    )
                )
        return "\n".join(lines)

    def print_summary(self):
        print(self.summary())


_global = StatSet()


def global_stats() -> StatSet:
    return _global


def timer(name):
    """with timer("forwardBackward"): ... — REGISTER_TIMER parity. Host
    wall time: on the card it times dispatch, not the device."""
    return _global.timer(name)


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
