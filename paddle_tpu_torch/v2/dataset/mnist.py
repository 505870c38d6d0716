"""MNIST reader creators (reference dataset/mnist.py API: train/test yield
(784-dim float in [-1,1], int label)).

Real data path: when the IDX-format gz files exist under
``common.DATA_HOME/mnist`` (the reference's download cache layout), they
are DECODED — magic 2051 image files / 2049 label files, gzip-wrapped,
exactly http://yann.lecun.com/exdb/mnist/ wire format. ``fetch()``
populates that cache; since nothing is downloaded it synthesises
REAL-FORMAT files from the deterministic corpus, so the decode path is
exercised either way. Without cached files the readers fall back to the
in-memory synthetic corpus directly.
"""

import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test", "fetch", "convert"]

N_TRAIN, N_TEST = 512, 128

# genuine-download checksums (reference dataset/mnist.py:28-34) — used
# by tests/test_real_archives.py to tell real archives from synthetics
TRAIN_IMAGE_MD5 = "f68b3c2dcbeaaa9fbdd348bbdeb94873"
TRAIN_LABEL_MD5 = "d53e105ee54ea40749a09fcbcd1e9432"
TEST_IMAGE_MD5 = "9fb629c4189551a2d022fa330f9573f3"
TEST_LABEL_MD5 = "ec29112dd5afa0611ce80d1b7f02629c"

_FILES = {
    "train": ("train-images-idx3-ubyte.gz", "train-labels-idx1-ubyte.gz"),
    "test": ("t10k-images-idx3-ubyte.gz", "t10k-labels-idx1-ubyte.gz"),
}


def _cache_dir():
    return os.path.join(common.DATA_HOME, "mnist")


def _synthetic(split, n):
    rng = common.rng_for("mnist", split)
    for _ in range(n):
        label = int(rng.randint(0, 10))
        img = rng.randn(784) * 0.3 - 0.5
        img[label * 70:(label + 1) * 70] += 1.2  # class-separable band
        yield img.clip(-1, 1).astype("float32"), label


def _write_idx(split, n, img_path, lbl_path):
    """Serialise the corpus in the REAL MNIST wire format. Never
    overwrites: a user may have placed genuine downloads in the cache
    (common.download points them here)."""
    imgs, labels = [], []
    for img, label in _synthetic(split, n):
        imgs.append(common.to_pixels(img))
        labels.append(label)
    if not os.path.exists(img_path):
        with gzip.open(img_path, "wb") as f:
            f.write(struct.pack(">IIII", 2051, len(imgs), 28, 28))
            f.write(np.stack(imgs).tobytes())
    if not os.path.exists(lbl_path):
        with gzip.open(lbl_path, "wb") as f:
            f.write(struct.pack(">II", 2049, len(labels)))
            f.write(np.asarray(labels, np.uint8).tobytes())


def fetch():
    """Populate the download cache (reference mnist.fetch). Nothing is
    downloaded, so real-FORMAT IDX files are synthesised for whichever
    files are missing (user-placed genuine files are left untouched)."""
    d = _cache_dir()
    os.makedirs(d, exist_ok=True)
    for split, (img_name, lbl_name) in _FILES.items():
        _write_idx(split, N_TRAIN if split == "train" else N_TEST,
                   os.path.join(d, img_name), os.path.join(d, lbl_name))
    return d


def _decode_idx(img_path, lbl_path):
    """Parse the IDX wire format (reference mnist.py reader_creator)."""
    with gzip.open(img_path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise IOError("%s: bad IDX image magic %d" % (img_path, magic))
        imgs = np.frombuffer(f.read(n * rows * cols), np.uint8)
        imgs = imgs.reshape(n, rows * cols)
    with gzip.open(lbl_path, "rb") as f:
        magic, n_l = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise IOError("%s: bad IDX label magic %d" % (lbl_path, magic))
        labels = np.frombuffer(f.read(n_l), np.uint8)
    if n != n_l:
        raise IOError("image/label count mismatch: %d vs %d" % (n, n_l))
    for i in range(n):
        # the reference normalises to [-1, 1] floats
        yield (common.from_pixels(imgs[i]), int(labels[i]))


def _reader(split, n):
    img_name, lbl_name = _FILES[split]

    def reader():
        img_path = os.path.join(_cache_dir(), img_name)
        lbl_path = os.path.join(_cache_dir(), lbl_name)
        if os.path.exists(img_path) and os.path.exists(lbl_path):
            yield from _decode_idx(img_path, lbl_path)
        else:
            yield from _synthetic(split, n)

    return reader


def train():
    return _reader("train", N_TRAIN)


def test():
    return _reader("test", N_TEST)


def convert(path):
    """Convert the dataset to record files (reference mnist.convert),
    through the native record writer."""
    common.convert(path, train(), 64, "mnist_train")
    common.convert(path, test(), 64, "mnist_test")
