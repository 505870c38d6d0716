"""CIFAR reader creators (reference dataset/cifar.py API: train10/test10
yield (3072 floats, int label); train100/test100 likewise).

Real data path: when ``cifar-10-python.tar.gz`` exists under
``common.DATA_HOME/cifar`` (the reference's download cache layout) it is
DECODED — the genuine https://www.cs.toronto.edu/~kriz/cifar wire format:
a tar.gz of pickled batches, each a dict with ``data`` uint8 [N, 3072]
and ``labels``. ``fetch()`` synthesises a real-format archive from the
deterministic corpus (the package downloads nothing), so the decode/shuffle path
runs either way; without a cache the readers fall back to the in-memory
synthetic corpus.
"""

import io
import os
import pickle
import tarfile

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100", "fetch", "convert"]

# genuine-download checksums (reference dataset/cifar.py:41-43)
CIFAR10_MD5 = "c58f30108f718f92721af3b95e74349a"
CIFAR100_MD5 = "eb9058c3a382ffc7106e4002c42a8d85"

_TAR10 = "cifar-10-python.tar.gz"


def _cache_path():
    return os.path.join(common.DATA_HOME, "cifar", _TAR10)


def _synthetic(split, n, classes):
    rng = common.rng_for("cifar%d" % classes, split)
    for _ in range(n):
        label = int(rng.randint(0, classes))
        img = rng.randn(3072) * 0.2
        img[(label % 3) * 1024:(label % 3) * 1024 + 256] += (
            (label + 1) / classes
        )
        yield img.astype("float32"), label


def fetch():
    """Populate the download cache with a REAL-FORMAT cifar-10 archive
    (reference cifar.fetch; files synthesised — nothing is downloaded)."""
    path = _cache_path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)

    def batch_bytes(split, n):
        data, labels = [], []
        for img, label in _synthetic(split, n, 10):
            # floats -> uint8 pixels like the original batches
            data.append(common.to_pixels(img))
            labels.append(label)
        return pickle.dumps(
            {b"data": np.stack(data), b"labels": labels}, protocol=2
        )

    with tarfile.open(path, "w:gz") as tar:
        for name, split, n in (
            ("cifar-10-batches-py/data_batch_1", "train", 512),
            ("cifar-10-batches-py/test_batch", "test", 128),
        ):
            payload = batch_bytes(split, n)
            info = tarfile.TarInfo(name)
            info.size = len(payload)
            tar.addfile(info, io.BytesIO(payload))
    return path


def _decode_tar(sub_name):
    """Decode the real CIFAR wire format (reference cifar.reader_creator:
    tar.gz of pickled batch dicts)."""
    with tarfile.open(_cache_path(), "r:gz") as tar:
        names = [
            m.name for m in tar.getmembers() if sub_name in m.name
        ]
        for name in sorted(names):
            batch = pickle.load(tar.extractfile(name), encoding="bytes")
            data = batch[b"data"]
            labels = batch.get(b"labels") or batch.get(b"fine_labels")
            for i in range(len(labels)):
                yield (common.from_pixels(data[i]), int(labels[i]))


def _reader(split, n, classes):
    sub = "data_batch" if split == "train" else "test_batch"

    def reader():
        if classes == 10 and os.path.exists(_cache_path()):
            yield from _decode_tar(sub)
        else:
            yield from _synthetic(split, n, classes)

    return reader


def train10():
    return _reader("train", 512, 10)


def test10():
    return _reader("test", 128, 10)


def train100():
    return _reader("train", 512, 100)


def test100():
    return _reader("test", 128, 100)


def convert(path):
    """Convert to record files via the native writer (reference
    cifar.convert)."""
    common.convert(path, train10(), 128, "cifar_train10")
    common.convert(path, test10(), 128, "cifar_test10")
