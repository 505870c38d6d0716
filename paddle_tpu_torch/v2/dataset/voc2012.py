"""VOC2012 segmentation reader creators (reference dataset/voc2012.py:
VOCtrainval tar with ImageSets/Segmentation/{train,val,trainval}.txt
name lists, JPEGImages/<name>.jpg photos and SegmentationClass/<name>.png
paletted class masks; readers yield (HWC uint8 image array, HW class
mask array) via PIL — including the reference's own split quirk:
train() reads the 'trainval' list and test() the 'train' list).

fetch() synthesises a REAL-FORMAT tarball (actual JPEG + paletted PNG
members via PIL) from the deterministic corpus; a real VOCtrainval tar
decodes through the same reader.
"""

import io
import os
import tarfile

import numpy as np

from . import common

__all__ = ["train", "test", "val", "fetch"]

SET_FILE = "VOCdevkit/VOC2012/ImageSets/Segmentation/{}.txt"
DATA_FILE = "VOCdevkit/VOC2012/JPEGImages/{}.jpg"
LABEL_FILE = "VOCdevkit/VOC2012/SegmentationClass/{}.png"
_H = _W = 64
_CLASSES = 21
N_TRAIN, N_VAL = 48, 16


def _path():
    return os.path.join(common.DATA_HOME, "voc2012",
                        "VOCtrainval_11-May-2012.tar")


def _synthetic_pairs():
    """(name, HWC uint8 image, HW uint8 mask): blocky class regions so
    masks look like segmentations, image colour follows the mask."""
    rng = common.rng_for("voc2012", "data")
    out = []
    for i in range(N_TRAIN + N_VAL):
        mask = np.zeros((_H, _W), np.uint8)
        for _ in range(int(rng.randint(2, 5))):
            c = int(rng.randint(1, _CLASSES))
            y, x = rng.randint(0, _H - 8), rng.randint(0, _W - 8)
            h, w = rng.randint(8, _H - y + 1), rng.randint(8, _W - x + 1)
            mask[y:y + h, x:x + w] = c
        m32 = mask.astype(np.int32)
        img = np.stack([(m32 * 11) % 256, (m32 * 29) % 256,
                        (m32 * 47) % 256], axis=-1).astype(np.float32)
        img += 20.0 * rng.rand(_H, _W, 3)
        out.append(("2012_%06d" % i,
                    np.clip(img, 0, 255).astype(np.uint8), mask))
    return out


def fetch():
    from PIL import Image

    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    pairs = _synthetic_pairs()
    names = [n for n, _, _ in pairs]
    sets = {
        "train": names[:N_TRAIN],
        "val": names[N_TRAIN:],
        "trainval": names,
    }
    # a deterministic 256-colour palette (the real VOC palette is also a
    # fixed class-indexed table; PIL reads the indices back either way)
    palette = []
    for c in range(256):
        palette += [(c * 37) % 256, (c * 73) % 256, (c * 151) % 256]
    with tarfile.open(path + ".tmp", "w") as tf:
        def add(name, blob):
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))

        for split, members in sets.items():
            add(SET_FILE.format(split),
                ("\n".join(members) + "\n").encode())
        for name, img, mask in pairs:
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=92)
            add(DATA_FILE.format(name), buf.getvalue())
            pim = Image.fromarray(mask, mode="P")
            pim.putpalette(palette)
            buf = io.BytesIO()
            pim.save(buf, format="PNG")
            add(LABEL_FILE.format(name), buf.getvalue())
    os.replace(path + ".tmp", path)
    return path


def reader_creator(filename, sub_name):
    from PIL import Image

    def reader():
        with tarfile.open(filename) as tarobject:
            name2mem = {m.name: m for m in tarobject.getmembers()}
            sets = tarobject.extractfile(
                name2mem[SET_FILE.format(sub_name)])
            for line in sets.read().decode().splitlines():
                line = line.strip()
                if not line:
                    continue
                data = tarobject.extractfile(
                    name2mem[DATA_FILE.format(line)]).read()
                label = tarobject.extractfile(
                    name2mem[LABEL_FILE.format(line)]).read()
                yield (np.array(Image.open(io.BytesIO(data))),
                       np.array(Image.open(io.BytesIO(label))))

    return reader


def train():
    """Reference quirk kept: train() reads the 'trainval' list."""
    return reader_creator(fetch(), "trainval")


def test():
    """Reference quirk kept: test() reads the 'train' list."""
    return reader_creator(fetch(), "train")


def val():
    return reader_creator(fetch(), "val")
