"""Classic image preprocessing helpers (reference
python/paddle/utils/image_util.py): resize/crop/flip/mean-subtract in the
CHW float layout the image models feed. Implemented on numpy + PIL; the
card never sees these — they run on the host in the input pipeline. PIL
is imported inside the functions, so importing the module needs only
numpy."""

from __future__ import annotations

import io

import numpy as np

__all__ = [
    "resize_image", "flip", "crop_img", "decode_jpeg", "preprocess_img",
    "load_meta", "load_image", "oversample", "ImageTransformer",
]


def _pil():
    from PIL import Image

    return Image


def resize_image(img, target_size):
    """Resize a PIL image so its SHORT side equals target_size, keeping
    aspect ratio (the standard eval-pipeline resize)."""
    w, h = img.size
    if w < h:
        size = (target_size, int(round(h * target_size / float(w))))
    else:
        size = (int(round(w * target_size / float(h))), target_size)
    return img.resize(size, _pil().BILINEAR)


def flip(im):
    """Horizontal mirror of a CHW (color) or HW (gray) array."""
    im = np.asarray(im)
    return im[..., ::-1].copy()


def crop_img(im, inner_size, color=True, test=True):
    """Crop a CHW/HW array to inner_size x inner_size: center crop in
    test mode, random crop + random mirror in train mode."""
    im = np.asarray(im)
    h, w = im.shape[-2], im.shape[-1]
    if test:
        top, left = (h - inner_size) // 2, (w - inner_size) // 2
        mirror = False
    else:
        top = np.random.randint(0, h - inner_size + 1)
        left = np.random.randint(0, w - inner_size + 1)
        mirror = bool(np.random.randint(0, 2))
    out = im[..., top:top + inner_size, left:left + inner_size]
    return flip(out) if mirror else out.copy()


def decode_jpeg(jpeg_string):
    """JPEG bytes -> CHW (color) or HW (gray) uint8 array."""
    img = _pil().open(io.BytesIO(jpeg_string))
    arr = np.asarray(img)
    if arr.ndim == 3:
        arr = arr.transpose(2, 0, 1)
    return arr


def preprocess_img(im, img_mean, crop_size, is_train, color=True):
    """Crop (+train-time mirror) then subtract the mean image; returns
    float32 flattened to the layer's input layout."""
    cropped = crop_img(im, crop_size, color=color, test=not is_train)
    out = cropped.astype(np.float32) - np.asarray(img_mean, np.float32).reshape(
        cropped.shape
    )
    return out.ravel()

def load_meta(meta_path, mean_img_size, crop_size, color=True):
    """Load a dataset meta file (the pickled dict
    ImageClassificationDatasetCreater writes, flattened mean image under
    'data_mean') and center-crop the mean to crop_size."""
    import pickle

    with open(meta_path, "rb") as f:
        meta = pickle.load(f)
    mean = np.asarray(meta["data_mean"], np.float32)
    if color:
        mean = mean.reshape(3, mean_img_size, mean_img_size)
    else:
        mean = mean.reshape(mean_img_size, mean_img_size)
    return crop_img(mean, crop_size, color=color, test=True)


def load_image(img_path, is_color=True):
    """Load an image file as a PIL image in RGB (or L) mode."""
    img = _pil().open(img_path)
    return img.convert("RGB" if is_color else "L")


def oversample(img, crop_dims):
    """10-crop oversampling (reference image_util.py:144): the 4 corners
    + center, plus their mirrors, for HWC input images; returns
    [10*N, ch, cw, C]-style stacked crops for a [N, H, W, C] batch."""
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[None]
    n, h, w, c = img.shape
    ch, cw = int(crop_dims[0]), int(crop_dims[1])
    tops = [0, 0, h - ch, h - ch, (h - ch) // 2]
    lefts = [0, w - cw, 0, w - cw, (w - cw) // 2]
    crops = []
    for im in img:
        views = [
            im[t:t + ch, l:l + cw] for t, l in zip(tops, lefts)
        ]
        crops.extend(views)
        crops.extend(v[:, ::-1] for v in views)
    return np.stack(crops)


class ImageTransformer:
    """Configurable HWC<->CHW, channel-swap, mean-subtract, scale pipeline
    (reference image_util.py:183)."""

    def __init__(self, transpose=None, channel_swap=None, mean=None,
                 is_color=True):
        self.transpose = transpose
        self.channel_swap = channel_swap
        self.mean = None if mean is None else np.asarray(mean, np.float32)
        self.is_color = is_color
        self.scale = None

    def set_transpose(self, order):
        self.transpose = order

    def set_channel_swap(self, order):
        self.channel_swap = order

    def set_scale(self, scale):
        self.scale = scale

    def set_mean(self, mean):
        self.mean = None if mean is None else np.asarray(mean, np.float32)

    def transformer(self, data):
        data = np.asarray(data, np.float32)
        if self.transpose is not None:
            data = data.transpose(self.transpose)
        if self.channel_swap is not None:
            data = data[np.asarray(self.channel_swap)]
        if self.scale is not None:
            data = data * self.scale
        if self.mean is not None:
            mean = self.mean
            if mean.ndim == 1 and data.ndim == 3:
                mean = mean.reshape(-1, 1, 1)
            data = data - mean
        return data
