"""The port's v2 datasets (paddle_tpu_torch.v2.dataset) against the JAX
package's (paddle_tpu.v2.dataset): every reader and split of the 14
modules, and their dict, vocab and info helpers, give the same records
from both packages, in three ways:

  synthetic    both caches empty (each package its own directory);
  jax_fetch    the JAX package's `fetch()` writes the real-format files,
               and the port decodes them;
  torch_fetch  the port's `fetch()` writes them, and the JAX package
               decodes them to the records it decodes from its own
               files (gzip and tar headers carry the write time, so the
               files are equal in their records, not in their bytes).

Records match exactly, arrays in dtype, shape and bytes: there is no
tolerance. `convert` files written by either package read the same
records in the other, `download` raises, and `fetch_all` loads neither
jax nor the JAX package.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu.v2.dataset as jds
import paddle_tpu_torch.v2.dataset as tds
from torch_native_build import ensure_jax_native

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = {"jax": jds, "torch": tds}
_CACHES = ("_CACHE", "_META", "_SYNTH_CACHE", "_SYNTH")

# (module, case) -> fn(module) giving a reader creator or a helper value
CASES = {
    ("mnist", "train"): lambda m: m.train(),
    ("mnist", "test"): lambda m: m.test(),
    ("cifar", "train10"): lambda m: m.train10(),
    ("cifar", "test10"): lambda m: m.test10(),
    ("cifar", "train100"): lambda m: m.train100(),
    ("cifar", "test100"): lambda m: m.test100(),
    ("imdb", "train"): lambda m: m.train(m.word_dict()),
    ("imdb", "test"): lambda m: m.test(m.word_dict()),
    ("imdb", "word_dict"): lambda m: m.word_dict(),
    ("imdb", "build_dict"): lambda m: m.build_dict(
        __import__("re").compile(r"aclImdb/test/.*\.txt$"), 2),
    ("imikolov", "train_ngram"): lambda m: m.train(m.build_dict(), 5),
    ("imikolov", "test_ngram"): lambda m: m.test(m.build_dict(), 5),
    ("imikolov", "train_seq"): lambda m: m.train(
        m.build_dict(), 0, m.DataType.SEQ),
    ("imikolov", "test_seq"): lambda m: m.test(
        m.build_dict(), 0, m.DataType.SEQ),
    ("imikolov", "build_dict"): lambda m: m.build_dict(),
    ("imikolov", "build_dict_freq_5"): lambda m: m.build_dict(5),
    ("sentiment", "train"): lambda m: m.train(),
    ("sentiment", "test"): lambda m: m.test(),
    ("sentiment", "get_word_dict"): lambda m: m.get_word_dict(),
    ("movielens", "train"): lambda m: m.train(),
    ("movielens", "test"): lambda m: m.test(),
    ("movielens", "ids"): lambda m: (m.max_user_id(), m.max_movie_id(),
                                     m.max_job_id()),
    ("movielens", "age_table"): lambda m: list(m.age_table),
    ("movielens", "movie_categories"): lambda m: m.movie_categories(),
    ("movielens", "title_dict"): lambda m: m.get_movie_title_dict(),
    ("movielens", "user_info"): lambda m: m.user_info(),
    ("movielens", "movie_info"): lambda m: m.movie_info(),
    ("conll05", "test"): lambda m: m.test(),
    ("conll05", "get_dict"): lambda m: m.get_dict(),
    ("conll05", "get_embedding"): lambda m: m.get_embedding(),
    ("wmt14", "train"): lambda m: m.train(30),
    ("wmt14", "test"): lambda m: m.test(30),
    ("wmt14", "get_dict"): lambda m: m.get_dict(30),
    ("wmt14", "get_dict_forward"): lambda m: m.get_dict(30, reverse=False),
    ("wmt16", "train"): lambda m: m.train(40, 50),
    ("wmt16", "test"): lambda m: m.test(40, 50),
    ("wmt16", "validation"): lambda m: m.validation(40, 50),
    ("wmt16", "train_de"): lambda m: m.train(40, 50, src_lang="de"),
    ("wmt16", "get_dict_en"): lambda m: m.get_dict("en", 40),
    ("wmt16", "get_dict_de_reverse"): lambda m: m.get_dict("de", 50, True),
    ("mq2007", "train_pairwise"): lambda m: m.train(),
    ("mq2007", "test_pairwise"): lambda m: m.test(),
    ("mq2007", "train_pointwise"): lambda m: m.train("pointwise"),
    ("mq2007", "train_listwise"): lambda m: m.train("listwise"),
    ("mq2007", "test_listwise"): lambda m: m.test("listwise"),
    ("criteo", "train"): lambda m: m.train(),
    ("criteo", "test"): lambda m: m.test(),
    ("criteo", "train_64_buckets"): lambda m: m.train(64),
    ("criteo", "vocab_size"): lambda m: (m.vocab_size(), m.vocab_size(64),
                                         m.NUM_DENSE, m.NUM_SPARSE),
    ("uci_housing", "train"): lambda m: m.train(),
    ("uci_housing", "test"): lambda m: m.test(),
    ("uci_housing", "feature_names"): lambda m: list(m.feature_names),
    ("flowers", "train"): lambda m: m.train(),
    ("flowers", "test"): lambda m: m.test(),
    ("flowers", "valid"): lambda m: m.valid(),
    ("voc2012", "train"): lambda m: m.train(),
    ("voc2012", "test"): lambda m: m.test(),
    ("voc2012", "val"): lambda m: m.val(),
}

MODES = ("synthetic", "jax_fetch", "torch_fetch")


def test_cases_cover_every_module():
    assert sorted({m for m, _ in CASES}) == sorted(
        n for n in jds.__all__ if n != "common") == sorted(
        n for n in tds.__all__ if n != "common")


def _clear(mod):
    """Drop a module's in-process corpus caches, so a case reads what
    its own cache directory holds."""
    for name in _CACHES:
        c = getattr(mod, name, None)
        if c is not None:
            c.clear()


def _norm(x, home):
    """A hashable, exact form of a record or a helper value: arrays keep
    dtype, shape and bytes; a path under the cache becomes its place in
    the cache and its bytes."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.tobytes())
    if isinstance(x, (list, tuple)):
        return (type(x).__name__, tuple(_norm(v, home) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple(sorted((_norm(k, home), _norm(v, home))
                                     for k, v in x.items())))
    if isinstance(x, str) and home and x.startswith(home) and \
            os.path.isfile(x):
        with open(x, "rb") as f:
            return ("file", os.path.relpath(x, home), f.read())
    if isinstance(x, (bool, int, float, str, bytes, type(None))):
        return (type(x).__name__, x)
    return (type(x).__name__, _norm(vars(x), home))


def _take(side, module, case, home, monkeypatch):
    """What one package's case gives with its cache at `home`."""
    mod = getattr(SIDES[side], module)
    monkeypatch.setattr(SIDES[side].common, "DATA_HOME", home)
    _clear(mod)
    np.random.seed(7)  # flowers' train mapper crops and flips at random
    got = CASES[(module, case)](mod)
    if callable(got):
        got = list(got())
        assert got, "%s %s.%s gave no records" % (side, module, case)
    return [_norm(r, home) for r in got] if isinstance(got, list) \
        else _norm(got, home)


def _fetch(side, module, home, monkeypatch):
    monkeypatch.setattr(SIDES[side].common, "DATA_HOME", home)
    getattr(SIDES[side], module).fetch()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("module,case", sorted(CASES),
                         ids=["%s.%s" % k for k in sorted(CASES)])
def test_records_match_the_jax_package(tmp_path, monkeypatch, module, case,
                                       mode):
    jhome, thome = str(tmp_path / "jax"), str(tmp_path / "torch")
    if mode == "synthetic":
        want = _take("jax", module, case, jhome, monkeypatch)
        got = _take("torch", module, case, thome, monkeypatch)
    elif mode == "jax_fetch":
        _fetch("jax", module, jhome, monkeypatch)
        want = _take("jax", module, case, jhome, monkeypatch)
        got = _take("torch", module, case, jhome, monkeypatch)
    else:
        _fetch("jax", module, jhome, monkeypatch)
        _fetch("torch", module, thome, monkeypatch)
        want = _take("jax", module, case, jhome, monkeypatch)
        got = _take("jax", module, case, thome, monkeypatch)
        assert _take("torch", module, case, thome, monkeypatch) == got
    assert got == want


CONVERTS = {
    "mnist": lambda m, p: m.convert(p),
    "cifar": lambda m, p: m.convert(p),
    "imdb": lambda m, p: m.convert(p),
    "imikolov": lambda m, p: m.convert(p),
    "sentiment": lambda m, p: m.convert(p),
    "movielens": lambda m, p: m.convert(p),
    "conll05": lambda m, p: m.convert(p),
    "wmt14": lambda m, p: m.convert(p),
    "wmt16": lambda m, p: m.convert(p, 40, 50, "en"),
    "criteo": lambda m, p: m.convert(p),
    "uci_housing": lambda m, p: m.convert(p),
}


def _converted(side, out):
    """{file name: records} of a convert() output directory, read by one
    package's read_converted."""
    names = sorted(n for n in os.listdir(out) if not n.startswith("."))
    read = SIDES[side].common.read_converted
    return {n: list(read([os.path.join(out, n)])()) for n in names}


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("module", sorted(CONVERTS))
def test_convert_files_cross_read(tmp_path, monkeypatch, module, writer):
    """convert() through either package's native record writer: the
    other package's read_converted reads every file back to the same
    records as the writer's own, and both packages name and fill the
    files alike."""
    ensure_jax_native()
    for side in SIDES:
        monkeypatch.setattr(SIDES[side].common, "DATA_HOME",
                            str(tmp_path / ("home_" + side)))
        _clear(getattr(SIDES[side], module))
    outs = {}
    for side in SIDES:
        outs[side] = str(tmp_path / ("out_" + side))
        CONVERTS[module](getattr(SIDES[side], module), outs[side])
    reader = "torch" if writer == "jax" else "jax"
    mine = _converted(writer, outs[writer])
    theirs = _converted(reader, outs[writer])
    assert mine and all(mine.values())
    assert sorted(mine) == sorted(_converted(reader, outs[reader]))
    for name in mine:
        assert [_norm(r, None) for r in theirs[name]] == \
            [_norm(r, None) for r in mine[name]]


def test_common_convert_and_read_converted_stream(tmp_path):
    """common.convert splits a stream into line_count-record files named
    like the JAX package's, and read_converted streams them in order."""
    ensure_jax_native()
    samples = [(i, np.arange(i, dtype=np.int64)) for i in range(23)]
    paths = {side: SIDES[side].common.convert(
        str(tmp_path / side), lambda: iter(samples), 10, "s")
        for side in SIDES}
    assert [os.path.basename(p) for p in paths["torch"]] == \
        [os.path.basename(p) for p in paths["jax"]] == \
        ["s-00000-of-00003", "s-00001-of-00003", "s-00002-of-00003"]
    for w in SIDES:
        for r in SIDES:
            got = list(SIDES[r].common.read_converted(paths[w])())
            assert [_norm(s, None) for s in got] == \
                [_norm(s, None) for s in samples]


def test_common_helpers_match():
    jc, tc = jds.common, tds.common
    for name, split in (("mnist", "train"), ("imdb", "x/y"), ("", "")):
        assert (jc.rng_for(name, split).randint(0, 2**31, 8) ==
                tc.rng_for(name, split).randint(0, 2**31, 8)).all()
    img = np.random.RandomState(0).uniform(-1.2, 1.2, 300)
    px = tc.to_pixels(img)
    assert px.dtype == np.uint8 and (px == jc.to_pixels(img)).all()
    assert tc.from_pixels(px).tobytes() == jc.from_pixels(px).tobytes()
    freq = {"a": 3, "b": 3, "c": 1, "d": 7, "e": 0}
    assert tc.ranked_vocab(freq) == jc.ranked_vocab(freq)
    assert tc.ranked_vocab(freq, 1) == jc.ranked_vocab(freq, 1)
    assert tds.mnist.TRAIN_IMAGE_MD5 == jds.mnist.TRAIN_IMAGE_MD5
    assert tds.mnist.TEST_LABEL_MD5 == jds.mnist.TEST_LABEL_MD5
    assert (tds.mnist.N_TRAIN, tds.mnist.N_TEST) == (512, 128)


def test_data_home_is_the_jax_packages(tmp_path):
    """The same variable and default place: archives placed once serve
    both packages. DATA_HOME is read at import, in a fresh process."""
    code = ("import paddle_tpu_torch.v2.dataset.common as c; "
            "print(c.DATA_HOME)")
    env = dict(os.environ, PADDLE_TPU_DATA_HOME=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == str(tmp_path), out.stderr
    env.pop("PADDLE_TPU_DATA_HOME")
    env["HOME"] = str(tmp_path / "h")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == os.path.join(
        str(tmp_path / "h"), ".cache", "paddle_tpu", "dataset")
    assert not os.path.exists(str(tmp_path / "h")), \
        "importing the datasets touched the cache"


def test_md5file_and_download(tmp_path):
    p = tmp_path / "blob"
    p.write_bytes(os.urandom(10000))
    assert tds.common.md5file(str(p)) == jds.common.md5file(str(p))
    with pytest.raises(RuntimeError, match="never downloaded"):
        tds.common.download("http://example.invalid/x.tgz", "mnist", "0")
    with pytest.raises(RuntimeError):
        jds.common.download("http://example.invalid/x.tgz", "mnist", "0")


def _tree(home):
    return sorted(os.path.relpath(os.path.join(d, f), home)
                  for d, _, files in os.walk(home) for f in files)


def test_fetch_all_loads_neither_jax_nor_the_jax_package(tmp_path,
                                                         monkeypatch):
    """fetch_all walks the port's own dataset package: it fills the
    cache with the files the JAX package's fetch_all writes, and loads
    neither jax nor paddle_tpu."""
    code = (
        "import sys\n"
        "from paddle_tpu_torch.v2.dataset import common\n"
        "common.fetch_all()\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(repr(bad))\n")
    home = str(tmp_path / "torch")
    env = dict(os.environ, PADDLE_TPU_DATA_HOME=home)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
    monkeypatch.setattr(jds.common, "DATA_HOME", str(tmp_path / "jax"))
    jds.common.fetch_all()
    assert _tree(home) == _tree(str(tmp_path / "jax"))
    assert len(os.listdir(home)) == len(tds.__all__) - 1
