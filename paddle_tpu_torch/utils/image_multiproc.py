"""Multi-process image preprocessing (reference
python/paddle/utils/image_multiproc.py): decode + resize + crop/flip +
mean-subtract in a worker pool so the host input pipeline keeps up with
the card. cv2 is optional (not in this image); the PIL path is the
default transformer.

The pool's workers are started with `spawn`, never `fork`: the pool is
often made inside a process that holds a CUDA context and live threads
(a trainer, a feeder, a fleet), and a forked child that inherits a lock
another thread held can hang. A spawned worker imports this module
afresh to unpickle `_TransformJob` and the transformer, so both live at
module level; the import loads numpy and PIL, not torch (the package
imports torch only where a module needs it), so a worker starts in
well under a second.
With `is_train=True` each worker draws its crops and flips from its own
`np.random` state."""

from __future__ import annotations

import io

import numpy as np

from .image_util import ImageTransformer

__all__ = ["PILTransformer", "MultiProcessImageTransformer"]

START_METHOD = "spawn"


class PILTransformer(ImageTransformer):
    """Decode (bytes or file), short-side resize, crop/flip, normalize
    — one sample at a time, picklable for worker processes."""

    def __init__(self, min_size=None, crop_size=None, transpose=(2, 0, 1),
                 channel_swap=None, mean=None, is_train=True, is_color=True):
        ImageTransformer.__init__(self, transpose, channel_swap, mean,
                                  is_color)
        self.min_size = min_size
        self.crop_size = crop_size
        self.is_train = is_train

    def _load(self, data):
        from PIL import Image

        if isinstance(data, (bytes, bytearray)):
            img = Image.open(io.BytesIO(bytes(data)))
        else:
            img = Image.open(data)
        return img.convert("RGB" if self.is_color else "L")

    def resize(self, im, min_size):
        from .image_util import resize_image

        return resize_image(im, min_size)

    def crop_and_flip(self, arr):
        h, w = arr.shape[:2]
        if self.is_train:
            top = np.random.randint(0, h - self.crop_size + 1)
            left = np.random.randint(0, w - self.crop_size + 1)
        else:
            top, left = (h - self.crop_size) // 2, (w - self.crop_size) // 2
        arr = arr[top:top + self.crop_size, left:left + self.crop_size]
        if self.is_train and np.random.randint(0, 2):
            arr = arr[:, ::-1]
        return arr

    def transform(self, im):
        arr = np.asarray(im)
        if self.crop_size:
            arr = self.crop_and_flip(arr)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return self.transformer(arr).astype(np.float32)

    def load_image_from_string(self, data):
        im = self._load(data)
        if self.min_size:
            im = self.resize(im, self.min_size)
        return self.transform(im)

    load_image_from_file = load_image_from_string

    def __call__(self, data, label):
        return self.load_image_from_string(data), label


class MultiProcessImageTransformer(object):
    """Fan the per-sample transformer over a multiprocessing pool;
    `run(data, labels)` yields transformed (image, label) pairs in order
    (reference image_multiproc.py MultiProcessImageTransformer).
    `close()` (or leaving a `with` block) stops the workers."""

    def __init__(self, procnum=10, resize_size=None, crop_size=None,
                 transpose=(2, 0, 1), channel_swap=None, mean=None,
                 is_train=True, is_color=True):
        import multiprocessing

        self.procnum = procnum
        self.transformer = PILTransformer(
            resize_size, crop_size, transpose, channel_swap, mean,
            is_train, is_color,
        )
        self.pool = multiprocessing.get_context(START_METHOD).Pool(procnum)

    def run(self, data, label):
        return self.pool.imap(
            _TransformJob(self.transformer), zip(data, label)
        )

    def close(self):
        self.pool.close()
        self.pool.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _TransformJob(object):
    """Picklable callable for pool workers."""

    def __init__(self, transformer):
        self.transformer = transformer

    def __call__(self, pair):
        data, label = pair
        return self.transformer(data, label)
