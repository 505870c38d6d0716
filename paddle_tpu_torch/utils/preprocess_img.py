"""Image-classification dataset preprocessing (reference
python/paddle/utils/preprocess_img.py): walk data_path/{train,test}/
<label>/*.jpg, resize, batch-pickle, and write a meta file with the mean
image — the on-disk format the legacy image configs trained from."""

from __future__ import annotations

import io
import os

import numpy as np

from . import preprocess_util
from .image_util import crop_img

__all__ = ["resize_image", "DiskImage", "ImageClassificationDatasetCreater"]


def resize_image(img, target_size):
    """Resize a PIL image so the SHORT edge equals target_size."""
    from PIL import Image

    percent = target_size / float(min(img.size[0], img.size[1]))
    size = (
        int(round(img.size[0] * percent)),
        int(round(img.size[1] * percent)),
    )
    return img.resize(size, Image.LANCZOS)


class DiskImage:
    """Lazily-read image on disk; converts to CHW array or stored JPEG
    bytes for the pickled batch."""

    def __init__(self, path, target_size):
        self.path = path
        self.target_size = target_size
        self.img = None

    def read_image(self):
        if self.img is None:
            from PIL import Image

            self.img = resize_image(Image.open(self.path), self.target_size)

    def convert_to_array(self):
        self.read_image()
        arr = np.array(self.img)
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        return arr

    def convert_to_paddle_format(self):
        """JPEG bytes — batches store compressed images."""
        self.read_image()
        out = io.BytesIO()
        self.img.convert("RGB").save(out, "jpeg")
        return out.getvalue()


class ImageClassificationDatasetCreater(preprocess_util.DatasetCreater):
    """Walks <data_path>/{train,test}/<label>/ images into pickled
    batches + a meta file carrying the mean image."""

    def __init__(self, data_path, target_size, color=True):
        preprocess_util.DatasetCreater.__init__(self, data_path)
        self.target_size = target_size
        self.color = color
        self.keys = ["images", "labels"]
        self.permute_key = "labels"
        self.num_classes = 0

    def create_dataset_from_dir(self, path):
        labels = preprocess_util.get_label_set_from_dir(path)
        self.num_classes = len(labels)
        items = []
        for name, label_id in labels.items():
            d = os.path.join(path, name)
            for f in preprocess_util.list_images(d):
                items.append((
                    DiskImage(os.path.join(d, f), self.target_size),
                    preprocess_util.Label(label_id, name),
                ))
        return preprocess_util.Dataset(items, self.keys)

    def create_meta_file(self, data):
        out = os.path.join(
            self.data_path, self.batch_dir_name, self.meta_filename
        )
        shape = (
            (3, self.target_size, self.target_size)
            if self.color
            else (self.target_size, self.target_size)
        )
        mean_img = np.zeros(shape, np.float64)
        for item in data.data:
            mean_img += crop_img(
                item[0].convert_to_array(), self.target_size, self.color
            )
        if data.data:
            mean_img /= len(data.data)
        preprocess_util.save_file(
            {
                "data_mean": mean_img.astype("int32").flatten(),
                "image_size": self.target_size,
                "mean_image_size": self.target_size,
                "num_classes": self.num_classes,
                "color": self.color,
            },
            out,
        )
