"""Percentiles as numpy's linear interpolation (the arithmetic of the
port's load generator, frozen here)."""

import numpy as np


def pct(xs, q):
    """The q-th percentile of xs (linear interpolation); None if empty."""
    if not len(xs):
        return None
    return float(np.percentile(np.asarray(xs, np.float64), q))

