"""paddle.v2.image: image decode / resize / crop / flip / transform
utilities (counterpart of paddle_tpu/v2/image.py; reference
python/paddle/v2/image.py, which wraps cv2).

PIL is imported only inside the functions that decode or resize, so the
v2 package imports without it. PIL + numpy implementation (cv2 is not a
dependency): same API and
HWC-uint8 in / CHW-float out conventions. Color images are RGB order
(the reference's cv2 path is BGR — documented divergence; the mean
argument of simple_transform is applied per channel in the order given,
so models trained here are self-consistent).
"""

from __future__ import annotations

import io
import tarfile

import numpy as np

__all__ = [
    "batch_images_from_tar",
    "load_image_bytes",
    "load_image",
    "resize_short",
    "to_chw",
    "center_crop",
    "random_crop",
    "left_right_flip",
    "simple_transform",
    "load_and_transform",
]


def load_image_bytes(bytes, is_color=True):  # noqa: A002 - reference name
    """Decode an encoded image buffer to an HWC uint8 array."""
    from PIL import Image

    img = Image.open(io.BytesIO(bytes))
    img = img.convert("RGB" if is_color else "L")
    arr = np.asarray(img, np.uint8)
    return arr


def load_image(file, is_color=True):  # noqa: A002 - reference name
    with open(file, "rb") as f:
        return load_image_bytes(f.read(), is_color=is_color)


def resize_short(im, size):
    """Resize so the SHORTER edge equals `size`, keeping aspect ratio
    (reference resize_short)."""
    from PIL import Image

    h, w = im.shape[:2]
    if h > w:
        new_w, new_h = size, int(round(h * size / w))
    else:
        new_w, new_h = int(round(w * size / h)), size
    img = Image.fromarray(im)
    return np.asarray(img.resize((new_w, new_h), Image.BILINEAR), im.dtype)


def to_chw(im, order=(2, 0, 1)):
    """HWC -> CHW (reference to_chw); grayscale gains a channel axis."""
    if im.ndim == 2:
        im = im[:, :, None]
    return im.transpose(order)


def center_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = max((h - size) // 2, 0)
    w0 = max((w - size) // 2, 0)
    return im[h0:h0 + size, w0:w0 + size]


def random_crop(im, size, is_color=True):
    h, w = im.shape[:2]
    h0 = np.random.randint(0, max(h - size, 0) + 1)
    w0 = np.random.randint(0, max(w - size, 0) + 1)
    return im[h0:h0 + size, w0:w0 + size]


def left_right_flip(im, is_color=True):
    return im[:, ::-1]


def simple_transform(im, resize_size, crop_size, is_train, is_color=True,
                     mean=None):
    """The standard train/test pipeline (reference simple_transform):
    resize_short -> (random crop + random flip | center crop) -> CHW
    float32 -> optional per-channel (or per-pixel) mean subtraction."""
    im = resize_short(im, resize_size)
    if is_train:
        im = random_crop(im, crop_size, is_color=is_color)
        if np.random.randint(2) == 0:
            im = left_right_flip(im, is_color=is_color)
    else:
        im = center_crop(im, crop_size, is_color=is_color)
    im = to_chw(im).astype(np.float32)
    if mean is not None:
        mean = np.asarray(mean, np.float32)
        if mean.ndim == 1:
            mean = mean[:, None, None]
        im = im - mean
    return im


def load_and_transform(filename, resize_size, crop_size, is_train,
                       is_color=True, mean=None):
    return simple_transform(
        load_image(filename, is_color=is_color), resize_size, crop_size,
        is_train, is_color=is_color, mean=mean,
    )


def batch_images_from_tar(data_file, dataset_name, img2label,
                          num_per_batch=1024):
    """Pre-batch a tar of images into pickled {data, label} blocks
    (reference batch_images_from_tar): returns the meta file path."""
    import os
    import pickle

    out_path = "%s_%s_batch" % (data_file, dataset_name)
    if not os.path.isdir(out_path):
        os.makedirs(out_path)
    tf = tarfile.open(data_file)
    data, labels, file_id, names = [], [], 0, []
    for mem in tf.getmembers():
        if mem.name not in img2label:
            continue
        data.append(tf.extractfile(mem).read())
        labels.append(img2label[mem.name])
        if len(data) == num_per_batch:
            output = {"label": labels, "data": data}
            part = os.path.join(out_path, "batch_%d" % file_id)
            with open(part, "wb") as f:
                pickle.dump(output, f, protocol=2)
            names.append(part)
            file_id += 1
            data, labels = [], []
    if data:
        part = os.path.join(out_path, "batch_%d" % file_id)
        with open(part, "wb") as f:
            pickle.dump({"label": labels, "data": data}, f, protocol=2)
        names.append(part)
    meta = os.path.join(out_path, "batch_meta")
    with open(meta, "w") as f:
        f.write("\n".join(names))
    return meta
