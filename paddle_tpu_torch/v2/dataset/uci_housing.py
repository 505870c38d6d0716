"""UCI housing reader creators (reference dataset/uci_housing.py:
download housing.data, normalise features, 80/20 split, yield
(13 features, [price])).

Wire format: `housing.data` — whitespace-separated rows of 14 floats
(13 features + MEDV target), exactly the UCI archive layout the
reference parses with np.fromfile(sep=' ') (uci_housing.py:62
load_data). A real file placed in the cache is decoded; fetch()
synthesises a REAL-FORMAT file from the deterministic corpus, so the
parse/normalise path runs either way. Normalisation matches the
reference: x_i = (x_i - avg_i) / (max_i - min_i).
"""

import os

import numpy as np

from . import common

__all__ = ["train", "test", "feature_range", "fetch", "convert"]

UCI_DIM = 13
N_ROWS = 506  # the real dataset's row count
TRAIN_RATIO = 0.8

feature_names = [
    "CRIM", "ZN", "INDUS", "CHAS", "NOX", "RM", "AGE", "DIS", "RAD",
    "TAX", "PTRATIO", "B", "LSTAT",
]

_CACHE = {}


def _path():
    return os.path.join(common.DATA_HOME, "uci_housing", "housing.data")


def _synthetic_rows():
    """Deterministic corpus: linear-plus-noise target over plausible
    positive feature scales."""
    rng = common.rng_for("uci_housing", "data")
    w = common.rng_for("uci_housing", "w").randn(UCI_DIM)
    x = np.abs(rng.randn(N_ROWS, UCI_DIM)) * (
        1.0 + 10.0 * rng.rand(UCI_DIM)
    )
    y = x @ (w * 0.1) + 0.5 * rng.randn(N_ROWS) + 22.0
    return np.concatenate([x, y[:, None]], axis=1)


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        for row in _synthetic_rows():
            f.write(" ".join("%.4f" % v for v in row) + "\n")
    os.replace(tmp, path)
    return path


def _load():
    """Decode + normalise (reference load_data semantics). Only DECODED
    files are cached — a fallback result is recomputed so a
    housing.data that appears later in the process gets decoded."""
    path = _path()
    decode = os.path.exists(path)
    key = (path, decode)
    if key in _CACHE:
        return _CACHE[key]
    if decode:
        data = np.fromfile(path, sep=" ")
    else:
        data = _synthetic_rows().ravel()
    data = data.reshape(-1, UCI_DIM + 1)
    maximums = data.max(axis=0)
    minimums = data.min(axis=0)
    avgs = data.mean(axis=0)
    for i in range(UCI_DIM):
        data[:, i] = (data[:, i] - avgs[i]) / max(
            maximums[i] - minimums[i], 1e-12
        )
    _CACHE[key] = data.astype("float32")
    return _CACHE[key]


def _reader(lo, hi):
    def reader():
        data = _load()
        n = data.shape[0]
        for row in data[int(lo * n):int(hi * n)]:
            yield row[:-1], row[-1:]

    return reader


def train():
    return _reader(0.0, TRAIN_RATIO)


def test():
    return _reader(TRAIN_RATIO, 1.0)


def feature_range(maximums, minimums):
    """Reference saves a matplotlib bar chart of feature scales; kept as
    an API no-op (no plotting library is needed)."""


def convert(path):
    common.convert(path, train(), 128, "uci_housing_train")
    common.convert(path, test(), 128, "uci_housing_test")
