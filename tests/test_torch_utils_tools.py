"""The port's utils/ modules against the JAX package's on the same
seeded inputs: the image helpers and PILTransformer bit-equal (and the
spawn pool equal to them), the dataset creater's batch, list and meta
files equal, predefined_net's nets lowering to the same programs and
giving the same outputs from the same weights, dump_config and
make_model_diagram text equal, dump_v2_config files read by the other
package's show_pb, torch2paddle tars byte-equal, parse_log equal; the
completed flags (PADDLE_FLAGS, as the JAX package reads it, turns the
executor's numerics guard on), stat and logging modules. On the CPU."""

import importlib.util
import io
import logging
import os
import pickle
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.trainer_config_helpers as JTCH
import paddle_tpu.utils as jutils
import paddle_tpu_torch.trainer_config_helpers as TTCH
import paddle_tpu_torch.utils as tutils
from paddle_tpu.utils import dump_config as jdump
from paddle_tpu.utils import dump_v2_config as jdump2
from paddle_tpu.utils import image_multiproc as jmp
from paddle_tpu.utils import image_util as jiu
from paddle_tpu.utils import make_model_diagram as jdiag
from paddle_tpu.utils import plotcurve as jplot
from paddle_tpu.utils import predefined_net as jpn
from paddle_tpu.utils import preprocess_img as jpimg
from paddle_tpu.utils import preprocess_util as jpu
from paddle_tpu.utils import stat as jstat
from paddle_tpu.utils import torch2paddle as jt2p
from paddle_tpu.v2.parameters import Parameters as JParameters
from paddle_tpu_torch.utils import dump_config as tdump
from paddle_tpu_torch.utils import dump_v2_config as tdump2
from paddle_tpu_torch.utils import image_multiproc as tmp_
from paddle_tpu_torch.utils import image_util as tiu
from paddle_tpu_torch.utils import make_model_diagram as tdiag
from paddle_tpu_torch.utils import plotcurve as tplot
from paddle_tpu_torch.utils import predefined_net as tpn
from paddle_tpu_torch.utils import preprocess_img as tpimg
from paddle_tpu_torch.utils import preprocess_util as tpu
from paddle_tpu_torch.utils import show_pb as tshow
from paddle_tpu_torch.utils import stat as tstat
from paddle_tpu_torch.utils import torch2paddle as tt2p
from torch_legacy import fresh_names, run_both

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _standalone(name, rel):
    """A module file of the JAX package loaded under a private name:
    paddle_tpu/utils/show_pb.py binds sys.stdout as a default argument
    when it is imported, so importing it here under its own name would
    change where the JAX package's own tests read its output."""
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jshow = _standalone("_jax_show_pb", "paddle_tpu/utils/show_pb.py")


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _pil(seed, w=37, h=29, mode="RGB"):
    from PIL import Image

    rng = np.random.RandomState(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    return Image.fromarray(rng.randint(0, 256, shape).astype(np.uint8))


def _jpeg(img):
    buf = io.BytesIO()
    img.save(buf, "jpeg")
    return buf.getvalue()


# ---------------------------------------------------------------------
# image_util
# ---------------------------------------------------------------------

@pytest.mark.parametrize("w,h,size", [(37, 29, 16), (20, 48, 24),
                                      (32, 32, 32)])
def test_resize_decode_load(tmp_path, w, h, size):
    img = _pil(w * h, w, h)
    _same(np.asarray(tiu.resize_image(img, size)),
          np.asarray(jiu.resize_image(img, size)))
    _same(np.asarray(tpimg.resize_image(img, size)),
          np.asarray(jpimg.resize_image(img, size)))
    blob = _jpeg(img)
    _same(tiu.decode_jpeg(blob), jiu.decode_jpeg(blob))
    p = str(tmp_path / "x.png")
    img.save(p)
    for color in (True, False):
        _same(np.asarray(tiu.load_image(p, color)),
              np.asarray(jiu.load_image(p, color)))


@pytest.mark.parametrize("chw", [(3, 20, 24), (17, 19)])
def test_crop_flip_preprocess_oversample(chw):
    im = np.random.RandomState(1).randint(0, 256, chw).astype(np.uint8)
    _same(tiu.flip(im), jiu.flip(im))
    _same(tiu.crop_img(im, 12, test=True), jiu.crop_img(im, 12, test=True))
    # train mode draws from numpy's global RNG: the same seed, the same
    # crop and mirror
    np.random.seed(5)
    want = jiu.crop_img(im, 12, test=False)
    np.random.seed(5)
    _same(tiu.crop_img(im, 12, test=False), want)
    mean = np.random.RandomState(2).rand(*im.shape[:-2], 12, 12) * 50
    _same(tiu.preprocess_img(im, mean, 12, is_train=False),
          jiu.preprocess_img(im, mean, 12, is_train=False))
    hwc = np.random.RandomState(3).randint(0, 256, (2, 20, 24, 3))
    _same(tiu.oversample(hwc, (8, 10)), jiu.oversample(hwc, (8, 10)))


def test_image_transformer():
    hwc = np.random.RandomState(4).rand(6, 5, 3).astype(np.float32) * 255
    for kw in ({}, dict(transpose=(2, 0, 1), mean=[1.0, 2.0, 3.0]),
               dict(transpose=(2, 0, 1), channel_swap=(2, 1, 0),
                    mean=np.ones((3, 6, 5)))):
        j, t = jiu.ImageTransformer(**kw), tiu.ImageTransformer(**kw)
        j.set_scale(0.5)
        t.set_scale(0.5)
        _same(t.transformer(hwc), j.transformer(hwc))


@pytest.mark.parametrize("mode,min_size,crop", [("RGB", 24, 20),
                                                ("L", None, 16),
                                                ("RGB", 20, None)])
def test_pil_transformer_at_test_time(mode, min_size, crop):
    img = _pil(9, 30, 26, mode)
    blob = _jpeg(img)
    color = mode == "RGB"
    kw = dict(min_size=min_size, crop_size=crop, is_train=False,
              is_color=color, mean=np.full(3 if color else 1, 7.0))
    j, t = jmp.PILTransformer(**kw), tmp_.PILTransformer(**kw)
    (jo, jl), (to, tl) = j(blob, 3), t(blob, 3)
    _same(to, jo)
    assert tl == jl == 3


def test_spawn_pool_equals_the_in_process_transformer():
    """The port's pool (spawn workers) gives the JAX transformer's
    outputs, in order."""
    blobs = [_jpeg(_pil(20 + i, 24, 22)) for i in range(6)]
    labels = list(range(6))
    kw = dict(min_size=20, crop_size=16, is_train=False,
              mean=np.zeros(3, np.float32))
    want = [jmp.PILTransformer(**kw)(b, l) for b, l in zip(blobs, labels)]
    assert tmp_.START_METHOD == "spawn"
    with tmp_.MultiProcessImageTransformer(procnum=2, resize_size=20,
                                           crop_size=16, is_train=False,
                                           mean=np.zeros(3, np.float32)) \
            as pool:
        got = list(pool.run(blobs, labels))
    assert len(got) == len(want)
    for (go, gl), (wo, wl) in zip(got, want):
        _same(go, wo)
        assert gl == wl


# ---------------------------------------------------------------------
# preprocess_util / preprocess_img / predefined_net.image_data
# ---------------------------------------------------------------------

def _image_tree(root, labels=("cat", "dog", "eel"), n=5):
    for split in ("train", "test"):
        for li, lab in enumerate(labels):
            d = os.path.join(root, split, lab)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                _pil(100 * li + i + (50 if split == "test" else 0),
                     26, 22).save(os.path.join(d, "img%d.jpg" % i))


def _creater_outputs(pkg, root):
    """Run one package's creater over `root`; its files, loaded."""
    out = os.path.join(root, "batches")
    if os.path.exists(out):
        import shutil

        shutil.rmtree(out)
    c = pkg.ImageClassificationDatasetCreater(root, 16, color=True)
    c.num_per_batch = 4
    random.seed(7)
    c.create_batches()
    files = {}
    for f in sorted(os.listdir(out)):
        path = os.path.join(out, f)
        if f.endswith(".list"):
            files[f] = open(path).read()
        else:
            with open(path, "rb") as fh:
                files[f] = pickle.load(fh)
    return files


def test_dataset_creater_writes_the_same_files(tmp_path):
    root = str(tmp_path)
    _image_tree(root)
    want = _creater_outputs(jpimg, root)
    got = _creater_outputs(tpimg, root)
    assert sorted(got) == sorted(want)
    assert len([f for f in got if f.startswith("train_batch")]) == 4
    for name in want:
        w, g = want[name], got[name]
        if isinstance(w, dict):
            assert sorted(g) == sorted(w), name
            for k in w:
                if isinstance(w[k], np.ndarray):
                    _same(g[k], w[k])
                else:
                    assert g[k] == w[k], (name, k)
        else:
            assert g == w, name
    meta = os.path.join(root, "batches", "batches.meta")
    _same(tiu.load_meta(meta, 16, 12), jiu.load_meta(meta, 16, 12))
    for pn, tch in ((jpn, JTCH), (tpn, TTCH)):
        tch.reset_config({})
        assert pn.image_data(root, 16) == {
            "image_size": 16, "num_classes": 3, "is_color": True}
        src = tch.get_config_state()["data_sources"]
        assert src["module"] == "image_provider"
        assert src["args"]["num_classes"] == 3


def test_dataset_permute_and_lists(tmp_path):
    items = [("x%d" % i, jpu.Label(i % 3, str(i % 3))) for i in range(30)]
    titems = [("x%d" % i, tpu.Label(i % 3, str(i % 3))) for i in range(30)]
    j, t = jpu.Dataset(list(items), ["d", "l"]), \
        tpu.Dataset(list(titems), ["d", "l"])
    random.seed(3)
    j.permute(1, 9)
    random.seed(3)
    t.permute(1, 9)
    assert [x[0] for x in t.data] == [x[0] for x in j.data]
    for name in ("list_dirs", "list_images", "list_files"):
        _image_tree(str(tmp_path), n=2)
        p = str(tmp_path / "train" / "cat") if name != "list_dirs" \
            else str(tmp_path / "train")
        assert getattr(tpu, name)(p) == getattr(jpu, name)(p)


# ---------------------------------------------------------------------
# predefined_net: the same programs, the same outputs from one set of
# weights
# ---------------------------------------------------------------------

@pytest.mark.parametrize("builder,conf,channels", [
    ("simple_conv_net", {"image_size": 20, "num_classes": 4}, 1),
    ("small_vgg", {"image_size": 32, "num_classes": 10, "is_color": True},
     3),
])
def test_predefined_net_matches(builder, conf, channels):
    def build(tch):
        pn = tpn if tch is TTCH else jpn
        pn.training_settings()
        return {"out": getattr(pn, builder)(conf, is_predict=True)}

    size = conf["image_size"]
    x = np.random.RandomState(6).randn(
        2, channels * size * size).astype(np.float32)
    (out,), _progs, (jscope, _tscope) = run_both(
        build, {"input": x}, rtol=1e-5, atol=1e-5)
    assert np.asarray(out[0]).shape == (2, conf["num_classes"])
    assert any(n.endswith(".w0") or "conv" in n for n in jscope.keys())


# ---------------------------------------------------------------------
# dump_config / make_model_diagram / dump_v2_config / show_pb
# ---------------------------------------------------------------------

_CONF = (
    "settings(batch_size=8, learning_rate=0.1)\n"
    "img = data_layer(name='input', size=3 * 8 * 8)\n"
    "c = img_conv_layer(input=img, filter_size=3, num_channels=3,\n"
    "                   num_filters=4, act=LinearActivation())\n"
    "bn = batch_norm_layer(input=c, act=ReluActivation())\n"
    "p = img_pool_layer(input=bn, pool_size=2, stride=2)\n"
    "out = fc_layer(input=p, size=3, act=SoftmaxActivation())\n"
    "outputs(classification_cost(input=out,\n"
    "                            label=data_layer(name='label', size=3)))\n")


def test_dump_config_and_diagram_equal(tmp_path):
    conf = tmp_path / "conf.py"
    conf.write_text(_CONF)
    with fresh_names():
        want = jdump.dump_config(str(conf))
    with fresh_names():
        got = tdump.dump_config(str(conf))
    assert got == want
    assert "conv2d" in got and "batch_norm" in got
    dots = []
    for mod in (jdiag, tdiag):
        dot = str(tmp_path / ("%s.dot" % mod.__name__.split(".")[0]))
        with fresh_names():
            mod.make_diagram(str(conf), dot)
        dots.append(open(dot).read())
    assert dots[1] == dots[0] and "digraph" in dots[1]


def _mlp(pkg):
    v2 = pytest.importorskip(pkg + ".v2")
    from importlib import import_module

    topology = import_module(pkg + ".v2.topology")
    x = v2.layer.data(name="x", type=v2.data_type.dense_vector(4))
    y = v2.layer.fc(input=x, size=2, act=v2.activation.Softmax())
    return topology.Topology(y)


@pytest.mark.parametrize("binary", [False, True])
def test_dump_v2_config_read_by_the_other_show_pb(tmp_path, binary):
    paths = {}
    for pkg, dump in (("paddle_tpu", jdump2), ("paddle_tpu_torch", tdump2)):
        with fresh_names():
            topo = _mlp(pkg)
        paths[pkg] = str(tmp_path / ("%s.json%s" % (pkg, ".gz" * binary)))
        dump.dump_v2_config(topo, paths[pkg], binary=binary)

    def shown(show, path):
        out = io.StringIO()
        show.show_program(show.read_program(path), out)
        return out.getvalue()

    want = shown(jshow, paths["paddle_tpu"])
    assert "op mul" in want or "op fc" in want
    assert shown(jshow, paths["paddle_tpu_torch"]) == want
    assert shown(tshow, paths["paddle_tpu"]) == want
    assert tshow.main([paths["paddle_tpu_torch"]]) == 0
    assert tshow.main([]) == 1


# ---------------------------------------------------------------------
# torch2paddle
# ---------------------------------------------------------------------

def _state_dict():
    g = torch.Generator().manual_seed(11)
    return {"fc.weight": torch.randn(3, 4, generator=g),
            "fc.bias": np.arange(3, dtype=np.float64),
            "conv.weight": torch.randn(2, 3, 3, 3, generator=g),
            "emb.weight": torch.randn(5, 2, generator=g).double(),
            "unused": torch.zeros(1)}


@pytest.mark.parametrize("transpose", [None, ["conv.weight"], []])
def test_torch2paddle_tar_equal_and_read_by_jax(tmp_path, transpose):
    sd = _state_dict()
    name_map = {"fc.weight": "__fc_0__.w0", "fc.bias": "__fc_0__.wbias",
                "conv.weight": "conv.w0", "emb.weight": "emb"}
    blobs = []
    for mod in (jt2p, tt2p):
        f = io.BytesIO()
        names = mod.torch2paddle(sd, name_map, f, transpose=transpose)
        blobs.append((names, f.getvalue()))
    assert blobs[1] == blobs[0]
    path = tmp_path / "p.tar"
    assert tt2p.torch2paddle(sd, name_map, str(path),
                             transpose=transpose) == blobs[0][0]
    with open(path, "rb") as f:
        got = JParameters.from_tar(f)
    want = JParameters.from_tar(io.BytesIO(blobs[0][1]))
    assert sorted(got.names()) == sorted(name_map.values())
    for n in want.names():
        _same(got.get(n), want.get(n))
    with pytest.raises(KeyError):
        tt2p.torch2paddle(sd, {"missing": "x"}, io.BytesIO())


def test_torch2paddle_takes_bfloat16_through_float32():
    t = torch.randn(4, 3, generator=torch.Generator().manual_seed(2))
    f = io.BytesIO()
    tt2p.torch2paddle({"w": t.bfloat16()}, {"w": "w"}, f, transpose=())
    got = JParameters.from_tar(io.BytesIO(f.getvalue())).get("w")
    _same(np.asarray(got).reshape(4, 3), t.bfloat16().float().numpy())


# ---------------------------------------------------------------------
# plotcurve
# ---------------------------------------------------------------------

_LOG = ("I Trainer: Pass=0 Batch=10 AvgCost=1.5 Eval: error=0.5\n"
        "Pass=0 Batch=20 AvgCost=1.25 Eval: error=0.45\n"
        "I Tester: Test samples=100 AvgCost=1.2 Eval: error=0.4\n"
        "garbage line\n"
        "I Trainer: Pass=1 Batch=10 AvgCost=9e-1 Eval: error=0.3\n"
        "Test samples=100 AvgCost=0.8 Eval: error=0.2\n")


@pytest.mark.parametrize("keys", [["AvgCost"], ["AvgCost", "error"],
                                  ["error"]])
def test_parse_log_equal(keys):
    want = jplot.parse_log(keys, io.StringIO(_LOG))
    got = tplot.parse_log(keys, io.StringIO(_LOG))
    for g, w in zip(got, want):
        _same(g, w)


def test_plot_draws_the_same_pixels(tmp_path):
    pytest.importorskip("matplotlib")
    from PIL import Image

    pix = []
    for mod in (jplot, tplot):
        out = str(tmp_path / ("%s.png" % mod.__name__.split(".")[0]))
        mod.plot_paddle_curve(["AvgCost"], io.StringIO(_LOG), out)
        pix.append(np.asarray(Image.open(out)))
    _same(pix[1], pix[0])


# ---------------------------------------------------------------------
# flags, stat, logging and the package's exports
# ---------------------------------------------------------------------

_ENVS = [
    {},
    {"PADDLE_FLAGS": "check_nan_inf=1,v=2, trainer_count = 4"},
    {"PADDLE_FLAGS": "check_nan_inf=1", "PADDLE_FLAG_CHECK_NAN_INF": "0"},
    {"PADDLE_FLAG_USE_GPU": "False", "PADDLE_FLAG_PORT": "9000",
     "PADDLE_FLAGS": "port=1,use_gpu=1"},
]


def _flags_in_fresh_interpreter(path, env):
    """One package's flags module, loaded alone in a new interpreter
    under `env`: its FLAGS.as_dict()."""
    code = ("import importlib.util\n"
            "spec = importlib.util.spec_from_file_location('f', %r)\n"
            "m = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(m)\n"
            "print(repr(sorted(m.FLAGS.as_dict().items())))\n" % path)
    full = {k: v for k, v in os.environ.items()
            if not k.startswith("PADDLE_FLAG")}
    full.update(env)
    res = subprocess.run([sys.executable, "-c", code], env=full,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    return res.stdout.strip()


@pytest.mark.parametrize("env", _ENVS, ids=lambda e: ",".join(sorted(e))
                         or "none")
def test_flags_read_the_environment_as_the_jax_package(env):
    want = _flags_in_fresh_interpreter(
        os.path.join(ROOT, "paddle_tpu", "utils", "flags.py"), env)
    got = _flags_in_fresh_interpreter(
        os.path.join(ROOT, "paddle_tpu_torch", "utils", "flags.py"), env)
    assert got == want
    assert "('check_nan_inf'" in got


def test_paddle_flags_turn_the_numerics_guard_on():
    """PADDLE_FLAGS=check_nan_inf=1 (the JAX package's spelling) turns
    the port executor's guard on: a NaN fetch raises."""
    code = (
        "import numpy as np\n"
        "from paddle_tpu_torch import fluid\n"
        "from paddle_tpu_torch.utils import FLAGS\n"
        "assert FLAGS.check_nan_inf is True\n"
        "main, startup = fluid.Program(), fluid.Program()\n"
        "with fluid.program_guard(main, startup):\n"
        "    x = fluid.layers.data('x', shape=[4], dtype='float32')\n"
        "    m = fluid.layers.mean(x=x)\n"
        "exe = fluid.Executor(fluid.CPUPlace())\n"
        "bad = {'x': np.array([[1.0, np.nan, 2.0, 3.0]], np.float32)}\n"
        "try:\n"
        "    exe.run(main, feed=bad, fetch_list=[m])\n"
        "except FloatingPointError as e:\n"
        "    print('raised', m.name in str(e))\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PADDLE_FLAG")
           and k != "PADDLE_TPU_CHECK_NUMERICS"}
    env["PADDLE_FLAGS"] = "check_nan_inf=1"
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "raised True"


def test_numerics_guard_follows_the_flag(monkeypatch):
    from paddle_tpu_torch import fluid

    monkeypatch.delenv("PADDLE_TPU_CHECK_NUMERICS", raising=False)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4], dtype="float32")
        m = fluid.layers.mean(x=x)
    exe = fluid.Executor(fluid.CPUPlace())
    bad = {"x": np.array([[1.0, np.nan, 2.0, 3.0]], np.float32)}
    monkeypatch.setattr(tutils.FLAGS, "check_nan_inf", False)
    out = exe.run(main, feed=bad, fetch_list=[m])
    assert np.isnan(np.asarray(out[0])).all()
    monkeypatch.setattr(tutils.FLAGS, "check_nan_inf", True)
    with pytest.raises(FloatingPointError):
        exe.run(main, feed=bad, fetch_list=[m])


def test_define_and_undefined_flags():
    tutils.DEFINE_int("test_torch_utils_width", 7)
    tutils.DEFINE_string("test_torch_utils_name", "a")
    tutils.DEFINE_float("test_torch_utils_rate", 0.5)
    tutils.DEFINE_bool("test_torch_utils_on", 1)
    d = tutils.FLAGS.as_dict()
    assert (d["test_torch_utils_width"], d["test_torch_utils_name"],
            d["test_torch_utils_rate"], d["test_torch_utils_on"]) == \
        (7, "a", 0.5, True)
    with pytest.raises(AttributeError):
        tutils.FLAGS.no_such_flag


def test_stat_summary_format_equal():
    sets = []
    for mod in (jstat, tstat):
        s = mod.StatSet("parity")
        for name, dts in (("forwardBackward", (0.0125, 0.0031)),
                          ("update", (0.5,))):
            stat = s._stats.setdefault(name, mod._Stat())
            for dt in dts:
                stat.add(dt)
        sets.append(s)
    assert sets[1].summary() == sets[0].summary()
    g = tutils.global_stats()
    before = g._stats.get("test_torch_utils", tstat._Stat()).count
    with tutils.timer("test_torch_utils"):
        pass
    assert g._stats["test_torch_utils"].count == before + 1
    # host wall time, no device sync: on the card, dispatch
    assert "dispatch" in tstat.timer.__doc__


def test_vlog_gated_on_the_v_flag(monkeypatch):
    logger = tutils.get_logger()
    assert logger.name == "paddle_tpu_torch" and not logger.propagate
    seen = []

    class Keep(logging.Handler):
        def emit(self, record):
            seen.append(record.getMessage())

    h = Keep()
    logger.addHandler(h)
    try:
        monkeypatch.setattr(tutils.FLAGS, "v", 2)
        tutils.vlog(1, "shown %d", 1)
        tutils.vlog(3, "hidden %d", 3)
        monkeypatch.setattr(tutils.FLAGS, "v", 0)
        tutils.vlog(1, "hidden %d", 1)
    finally:
        logger.removeHandler(h)
    assert seen == ["shown 1"]


def test_utils_exports_cover_the_jax_package():
    assert set(jutils.__all__) <= set(tutils.__all__)
    for name in tutils.__all__:
        assert hasattr(tutils, name), name


def test_every_jax_file_has_a_counterpart():
    """A walk of both trees: every .py, .cc and .txt of paddle_tpu/ has a
    file at the same path in paddle_tpu_torch/."""
    missing = []
    jax_root = os.path.join(ROOT, "paddle_tpu")
    for dirpath, dirnames, files in os.walk(jax_root):
        dirnames[:] = [d for d in dirnames
                       if d != "__pycache__" and not d.startswith("_")]
        for f in files:
            if f.endswith((".py", ".cc", ".txt")):
                rel = os.path.relpath(os.path.join(dirpath, f), jax_root)
                if not os.path.exists(os.path.join(
                        ROOT, "paddle_tpu_torch", rel)):
                    missing.append(rel)
    assert missing == []


def test_importing_utils_loads_neither_pil_nor_matplotlib():
    code = ("import sys\n"
            "import paddle_tpu_torch.utils\n"
            "from paddle_tpu_torch.utils import (image_util, image_multiproc,"
            " preprocess_img, plotcurve, predefined_net, torch2paddle)\n"
            "print(sorted(m for m in ('PIL', 'matplotlib') "
            "if m in sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
    assert importlib.util.find_spec("PIL") is not None
