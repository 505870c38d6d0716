"""WMT14 reader creators (reference dataset/wmt14.py: a tgz holding
`*src.dict` / `*trg.dict` (one token per line, id = line number, first
three <s>/<e>/<unk>) plus parallel corpora members ending `train/train`
and `test/test` with one `source\\ttarget` pair per line; readers yield
(src ids <s>..<e>, trg ids <s>.., trg_next ids ..<e>), UNK_IDX=2,
sentences over 80 tokens skipped — wmt14.py:52-110 semantics exactly).

fetch() synthesises a REAL-FORMAT tarball from the deterministic
reverse-copy corpus (the 'translation' is the reversed source, so
seq2seq models have learnable structure); real files placed in the
cache decode identically.
"""

import io
import os
import tarfile

from . import common

__all__ = ["train", "test", "get_dict", "fetch", "N"]

N = 30  # default synthetic dict size cap (kept from round 1)
START, END, UNK_IDX = "<s>", "<e>", 2
_VOCAB = 60  # w0..; dict line order: <s>, <e>, <unk>, w0, w1, ...
N_TRAIN, N_TEST = 256, 64


def _path():
    return os.path.join(common.DATA_HOME, "wmt14", "wmt14.tgz")


def _dict_lines():
    return ["<s>", "<e>", "<unk>"] + ["w%d" % i for i in range(_VOCAB)]


def _synthetic_pairs(split, n):
    rng = common.rng_for("wmt14", split)
    for _ in range(n):
        l = int(rng.randint(2, 8))
        ids = rng.randint(3, 3 + _VOCAB, l)
        src = " ".join("w%d" % (i - 3) for i in ids)
        trg = " ".join("w%d" % (i - 3) for i in ids[::-1])
        yield "%s\t%s" % (src, trg)


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with tarfile.open(tmp, "w:gz") as tf:
        members = {
            "wmt14/src.dict": "\n".join(_dict_lines()) + "\n",
            "wmt14/trg.dict": "\n".join(_dict_lines()) + "\n",
            "wmt14/train/train": "\n".join(
                _synthetic_pairs("train", N_TRAIN)) + "\n",
            "wmt14/test/test": "\n".join(
                _synthetic_pairs("test", N_TEST)) + "\n",
        }
        for name, text in members.items():
            blob = text.encode()
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    os.replace(tmp, path)
    return path


def _read_dicts(dict_size):
    path = _path()
    if os.path.exists(path):
        out = []
        with tarfile.open(path) as tf:
            for suffix in ("src.dict", "trg.dict"):
                names = [m.name for m in tf if m.name.endswith(suffix)]
                lines = (
                    tf.extractfile(names[0]).read().decode().splitlines()
                )
                out.append(
                    {w: i for i, w in enumerate(lines[:dict_size])}
                )
        return out[0], out[1]
    d = {w: i for i, w in enumerate(_dict_lines()[:dict_size])}
    return d, dict(d)  # the synthetic corpus shares src/trg vocab


def get_dict(dict_size, reverse=True):
    """(src_dict, trg_dict); reverse=True (the REFERENCE default,
    wmt14.py:159) maps id -> word for decoding beam output."""
    src, trg = _read_dicts(dict_size)
    if reverse:
        src = {v: k for k, v in src.items()}
        trg = {v: k for k, v in trg.items()}
    return src, trg


def _pair_lines(split, n):
    path = _path()
    suffix = "train/train" if split == "train" else "test/test"
    if os.path.exists(path):
        with tarfile.open(path) as tf:
            names = [m.name for m in tf if m.name.endswith(suffix)]
            for name in names:
                for line in tf.extractfile(name).read().decode().splitlines():
                    yield line
    else:
        for line in _synthetic_pairs(split, n):
            yield line


def _reader_creator(split, n_items, dict_size):
    def reader():
        src_dict, trg_dict = _read_dicts(dict_size)
        for line in _pair_lines(split, n_items):
            parts = line.strip().split("\t")
            if len(parts) != 2:
                continue
            src_ids = [
                src_dict.get(w, UNK_IDX)
                for w in [START] + parts[0].split() + [END]
            ]
            trg_ids = [trg_dict.get(w, UNK_IDX) for w in parts[1].split()]
            if len(src_ids) > 80 or len(trg_ids) > 80:
                continue
            trg_next = trg_ids + [trg_dict[END]]
            trg_ids = [trg_dict[START]] + trg_ids
            yield src_ids, trg_ids, trg_next

    return reader


def train(dict_size):
    return _reader_creator("train", N_TRAIN, dict_size)


def test(dict_size):
    return _reader_creator("test", N_TEST, dict_size)


def convert(path):
    """Convert the dataset to record files (reference wmt14.convert),
    through the native record writer."""
    dict_size = 30000
    common.convert(path, train(dict_size), 1000, "wmt14_train")
    common.convert(path, test(dict_size), 1000, "wmt14_test")
