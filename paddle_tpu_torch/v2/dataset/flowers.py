"""Flowers-102 reader creators (reference dataset/flowers.py:
102flowers.tgz of jpg/image_NNNNN.jpg members plus imagelabels.mat
(1-based labels) and setid.mat (trnid/tstid/valid index arrays, with the
reference's deliberate train<->test flag swap: TRAIN_FLAG='tstid');
samples map through default_mapper = load_image_bytes + simple_transform
256->224 with the BGR mean — a flattened float32 3x224x224 vector and
the label.

fetch() synthesises REAL-FORMAT files (actual JPEG members via PIL,
actual .mat v5 files via scipy.io.savemat) from the deterministic
corpus; real downloads decode through the same path.
"""

import functools
import io
import os
import tarfile

import numpy as np

from . import common
from .. import image as paddle_image

__all__ = ["train", "test", "valid", "fetch"]

TRAIN_FLAG = "tstid"  # the reference swaps train/test on purpose
TEST_FLAG = "trnid"
VALID_FLAG = "valid"
N_IMAGES = 64
_CLASSES = 102
_SRC_HW = 96  # stored jpg size; simple_transform resizes to 256 -> 224


def _cache(name):
    return os.path.join(common.DATA_HOME, "flowers", name)


def _synthetic_images():
    """Deterministic (label, HWC uint8 image) pairs: each class gets a
    distinct dominant colour so the data is separable after jpg loss."""
    rng = common.rng_for("flowers", "data")
    out = []
    for i in range(N_IMAGES):
        label = int(rng.randint(1, _CLASSES + 1))  # 1-based like the .mat
        base = np.array([
            (label * 53) % 256, (label * 97) % 256, (label * 193) % 256,
        ], np.float32)
        img = base[None, None, :] + 30.0 * rng.rand(_SRC_HW, _SRC_HW, 3)
        out.append((label, np.clip(img, 0, 255).astype(np.uint8)))
    return out


def fetch():
    d = os.path.dirname(_cache("x"))
    tgz = _cache("102flowers.tgz")
    labels_mat = _cache("imagelabels.mat")
    setid_mat = _cache("setid.mat")
    if all(os.path.exists(f) for f in (tgz, labels_mat, setid_mat)):
        return d
    from PIL import Image
    from scipy.io import savemat

    os.makedirs(d, exist_ok=True)
    data = _synthetic_images()
    if not os.path.exists(tgz):
        with tarfile.open(tgz + ".tmp", "w:gz") as tf:
            for i, (_, img) in enumerate(data):
                buf = io.BytesIO()
                Image.fromarray(img).save(buf, format="JPEG", quality=92)
                blob = buf.getvalue()
                info = tarfile.TarInfo("jpg/image_%05d.jpg" % (i + 1))
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
        os.replace(tgz + ".tmp", tgz)
    if not os.path.exists(labels_mat):
        savemat(labels_mat + ".tmp.mat",
                {"labels": np.array([[l for l, _ in data]], np.float64)})
        os.replace(labels_mat + ".tmp.mat", labels_mat)
    if not os.path.exists(setid_mat):
        ids = np.arange(1, N_IMAGES + 1)
        savemat(setid_mat + ".tmp.mat", {
            # 1-based image ids per split (reference layout)
            "tstid": ids[: N_IMAGES // 2][None],
            "trnid": ids[N_IMAGES // 2: 3 * N_IMAGES // 4][None],
            "valid": ids[3 * N_IMAGES // 4:][None],
        })
        os.replace(setid_mat + ".tmp.mat", setid_mat)
    return d


def default_mapper(is_train, sample):
    """Image bytes -> flattened f32 via the reference transform chain."""
    img, label = sample
    img = paddle_image.load_image_bytes(img)
    img = paddle_image.simple_transform(
        img, 256, 224, is_train, mean=[103.94, 116.78, 123.68])
    return img.flatten().astype("float32"), label


train_mapper = functools.partial(default_mapper, True)
test_mapper = functools.partial(default_mapper, False)


def _reader_creator(dataset_name, mapper):
    from scipy.io import loadmat

    def reader():
        fetch()
        labels = loadmat(_cache("imagelabels.mat"))["labels"].ravel()
        ids = loadmat(_cache("setid.mat"))[dataset_name].ravel()
        with tarfile.open(_cache("102flowers.tgz")) as tf:
            members = {m.name: m for m in tf.getmembers()}
            for img_id in ids:
                name = "jpg/image_%05d.jpg" % int(img_id)
                blob = tf.extractfile(members[name]).read()
                # reference yields int(label) - 1: 0-based classes
                # (flowers.py:119) despite the 1-based .mat labels
                yield mapper((blob, int(labels[int(img_id) - 1]) - 1))

    return reader


def train(mapper=train_mapper, buffered_size=1024, use_xmap=True):
    return _reader_creator(TRAIN_FLAG, mapper)


def test(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _reader_creator(TEST_FLAG, mapper)


def valid(mapper=test_mapper, buffered_size=1024, use_xmap=True):
    return _reader_creator(VALID_FLAG, mapper)
