"""The port's v2.image and v2.plot against the JAX package's: image.py's
functions on the same arrays and bytes give equal results (exactly:
the same PIL and numpy calls), and Ploter / PlotData record the same
steps and values, drawn under matplotlib's Agg backend to the same
pixels. Importing the port's v2 API loads neither PIL nor matplotlib."""

import io
import os
import subprocess
import sys
import tarfile

import numpy as np
import pytest
import torch

import paddle_tpu.v2.image as jimage
import paddle_tpu.v2.plot as jplot
import paddle_tpu_torch.v2.image as timage
import paddle_tpu_torch.v2.plot as tplot

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _img(seed, h=37, w=53, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.RandomState(seed).randint(0, 256, shape) \
        .astype(np.uint8)


def _encoded(arr, fmt):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
@pytest.mark.parametrize("is_color", [True, False])
def test_load_image_bytes_and_file(tmp_path, fmt, is_color):
    blob = _encoded(_img(0), fmt)
    _same(timage.load_image_bytes(blob, is_color),
          jimage.load_image_bytes(blob, is_color))
    p = tmp_path / ("x." + fmt.lower())
    p.write_bytes(blob)
    _same(timage.load_image(str(p), is_color),
          jimage.load_image(str(p), is_color))


@pytest.mark.parametrize("shape", [(37, 53, 3), (60, 20, 3), (31, 31, 0)])
@pytest.mark.parametrize("size", [16, 32, 100])
def test_geometry(shape, size):
    im = _img(1, *shape)
    _same(timage.resize_short(im, size), jimage.resize_short(im, size))
    _same(timage.to_chw(im), jimage.to_chw(im))
    _same(timage.center_crop(im, size), jimage.center_crop(im, size))
    _same(timage.left_right_flip(im), jimage.left_right_flip(im))
    np.random.seed(3)
    a = timage.random_crop(im, size)
    np.random.seed(3)
    _same(a, jimage.random_crop(im, size))


@pytest.mark.parametrize("is_train", [True, False])
@pytest.mark.parametrize("mean", [None, [103.94, 116.78, 123.68], "pixel"])
def test_simple_transform_and_load_and_transform(tmp_path, is_train, mean):
    im = _img(2, 48, 64)
    if mean == "pixel":
        mean = np.random.RandomState(4).rand(3, 24, 24).astype(np.float32)
    for seed in range(4):  # flips and crops at random when training
        np.random.seed(seed)
        a = timage.simple_transform(im, 32, 24, is_train, mean=mean)
        np.random.seed(seed)
        _same(a, jimage.simple_transform(im, 32, 24, is_train, mean=mean))
    p = tmp_path / "x.png"
    p.write_bytes(_encoded(im, "PNG"))
    np.random.seed(5)
    a = timage.load_and_transform(str(p), 32, 24, is_train, mean=mean)
    np.random.seed(5)
    _same(a, jimage.load_and_transform(str(p), 32, 24, is_train, mean=mean))


def test_batch_images_from_tar(tmp_path):
    """The pickled {data, label} batches and their meta file hold the
    same contents (paths differ only in the directory given)."""
    import pickle

    names = {}
    for side in ("jax", "torch"):
        tar = tmp_path / side / "imgs.tar"
        tar.parent.mkdir()
        with tarfile.open(str(tar), "w") as tf:
            for i in range(7):
                blob = _encoded(_img(10 + i, 8, 8), "PNG")
                info = tarfile.TarInfo("jpg/%d.png" % i)
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
        img2label = {"jpg/%d.png" % i: i % 3 for i in range(7) if i != 4}
        mod = jimage if side == "jax" else timage
        meta = mod.batch_images_from_tar(str(tar), "train", img2label,
                                         num_per_batch=2)
        with open(meta) as f:
            parts = f.read().split("\n")
        names[side] = [os.path.relpath(p, str(tmp_path / side))
                       for p in parts]
        names[side + "_data"] = [pickle.load(open(p, "rb")) for p in parts]
    assert names["jax"] == names["torch"]
    assert len(names["jax"]) == 3
    assert names["jax_data"] == names["torch_data"]


def test_ploter_records_and_draws_alike(tmp_path):
    pytest.importorskip("matplotlib")
    from PIL import Image

    out = {}
    for side, mod in (("jax", jplot), ("torch", tplot)):
        p = mod.Ploter("train cost", "test cost")
        for step in range(12):
            p.append("train cost", step, 1.0 / (step + 1))
            if step % 3 == 0:
                p.append("test cost", step, 1.2 / (step + 1))
        rec = {t: (p[t].step[:], p[t].value[:])
               for t in ("train cost", "test cost")}
        path = str(tmp_path / (side + ".png"))
        p.plot(path)
        out[side] = (rec, np.asarray(Image.open(path)))
        p.reset()
        assert p["train cost"].step == [] and p["test cost"].value == []
        p.plot()  # nothing recorded, no path: draws and closes
    assert out["jax"][0] == out["torch"][0]
    _same(out["torch"][1], out["jax"][1])
    d = tplot.PlotData()
    d.append(1, 2.0)
    assert (d.step, d.value) == ([1], [2.0])
    d.reset()
    assert (d.step, d.value) == ([], [])


def test_v2_import_loads_neither_pil_nor_matplotlib():
    code = ("import sys, paddle_tpu_torch.v2 as p\n"
            "assert p.dataset and p.plot and p.image\n"
            "p.plot.PlotData()\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('PIL', 'matplotlib', 'scipy')))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
