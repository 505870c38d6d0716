"""WMT16 (Multi30k-style) reader creators (reference dataset/wmt16.py:
`wmt16.tar.gz` holding members wmt16/{train,val,test} of `en\\tde`
parallel lines; dictionaries BUILT from the train corpus by frequency,
written to DATA_HOME/wmt16/<lang>_<size>.dict with the first three lines
<s>/<e>/<unk>, then loaded by line number — wmt16.py:59-137 semantics:
yields (src <s>..<e>, trg <s>.., trg_next ..<e>), unk id shared from the
source dict, src_lang selects the column).

fetch() synthesises a REAL-FORMAT tarball from the deterministic corpus
(German side = reversed English words with a 'de' suffix, so seq2seq
structure is learnable); real files decode identically.
"""

import io
import os
import tarfile
from collections import defaultdict

from . import common

__all__ = ["train", "test", "validation", "get_dict", "fetch"]

START_MARK, END_MARK, UNK_MARK = "<s>", "<e>", "<unk>"
# total dict entries INCLUDING the three marks (reference formula:
# min(dict_size, TOTAL_*_WORDS))
TOTAL_EN_WORDS = 63
TOTAL_DE_WORDS = 63
_VOCAB = 60
N_TRAIN, N_VAL, N_TEST = 256, 64, 64
_MEMBERS = {"train": "wmt16/train", "val": "wmt16/val",
            "test": "wmt16/test"}
_COUNTS = {"train": N_TRAIN, "val": N_VAL, "test": N_TEST}


def _path():
    return os.path.join(common.DATA_HOME, "wmt16", "wmt16.tar.gz")


def _synthetic_pairs(split, n):
    rng = common.rng_for("wmt16", split)
    for _ in range(n):
        l = int(rng.randint(2, 8))
        ids = rng.randint(0, _VOCAB, l)
        en = " ".join("w%d" % i for i in ids)
        de = " ".join("w%dde" % i for i in ids[::-1])
        yield "%s\t%s" % (en, de)


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with tarfile.open(tmp, "w:gz") as tf:
        for split, member in _MEMBERS.items():
            blob = ("\n".join(_synthetic_pairs(split, _COUNTS[split]))
                    + "\n").encode()
            info = tarfile.TarInfo(member)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    os.replace(tmp, path)
    return path


def _lines(split):
    path = _path()
    if os.path.exists(path):
        with tarfile.open(path) as tf:
            for line in tf.extractfile(
                    _MEMBERS[split]).read().decode().splitlines():
                yield line
    else:
        for line in _synthetic_pairs(split, _COUNTS[split]):
            yield line


def _build_dict(dict_size, save_path, lang):
    """Frequency dict over the train corpus column (reference
    __build_dict): first three lines are the marks."""
    word_dict = defaultdict(int)
    col = 0 if lang == "en" else 1
    for line in _lines("train"):
        parts = line.strip().split("\t")
        if len(parts) != 2:
            continue
        for w in parts[col].split():
            word_dict[w] += 1
    with open(save_path, "w") as fout:
        fout.write("%s\n%s\n%s\n" % (START_MARK, END_MARK, UNK_MARK))
        ranked = sorted(word_dict.items(), key=lambda x: x[1], reverse=True)
        for idx, (word, _) in enumerate(ranked):
            if idx + 3 == dict_size:
                break
            fout.write("%s\n" % word)


def _load_dict(dict_size, lang, reverse=False):
    dict_path = os.path.join(
        common.DATA_HOME, "wmt16", "%s_%d.dict" % (lang, dict_size))
    tar = _path()
    stale = (
        not os.path.exists(dict_path)
        or len(open(dict_path).readlines()) > dict_size
        # a corpus tarball that appeared (or changed) after the dict was
        # built invalidates it — a dict built from the synthetic
        # fallback must not decode a real corpus
        or (os.path.exists(tar)
            and os.path.getmtime(tar) > os.path.getmtime(dict_path))
    )
    if stale:
        os.makedirs(os.path.dirname(dict_path), exist_ok=True)
        _build_dict(dict_size, dict_path, lang)
    word_dict = {}
    with open(dict_path) as fdict:
        for idx, line in enumerate(fdict):
            if reverse:
                word_dict[idx] = line.strip()
            else:
                word_dict[line.strip()] = idx
    return word_dict


def _dict_size(src_dict_size, trg_dict_size, src_lang):
    src_dict_size = min(src_dict_size, (
        TOTAL_EN_WORDS if src_lang == "en" else TOTAL_DE_WORDS))
    trg_dict_size = min(trg_dict_size, (
        TOTAL_DE_WORDS if src_lang == "en" else TOTAL_EN_WORDS))
    return src_dict_size, trg_dict_size


def _reader_creator(split, src_dict_size, trg_dict_size, src_lang):
    def reader():
        src_dict = _load_dict(src_dict_size, src_lang)
        trg_dict = _load_dict(
            trg_dict_size, "de" if src_lang == "en" else "en")
        start_id = src_dict[START_MARK]
        end_id = src_dict[END_MARK]
        unk_id = src_dict[UNK_MARK]
        src_col = 0 if src_lang == "en" else 1
        for line in _lines(split):
            parts = line.strip().split("\t")
            if len(parts) != 2:
                continue
            src_ids = [start_id] + [
                src_dict.get(w, unk_id) for w in parts[src_col].split()
            ] + [end_id]
            trg_ids = [
                trg_dict.get(w, unk_id)
                for w in parts[1 - src_col].split()
            ]
            trg_next = trg_ids + [end_id]
            trg_ids = [start_id] + trg_ids
            yield src_ids, trg_ids, trg_next

    return reader


def _checked(src_dict_size, trg_dict_size, src_lang):
    if src_lang not in ("en", "de"):
        raise ValueError("src_lang must be 'en' or 'de'")
    return _dict_size(src_dict_size, trg_dict_size, src_lang)


def train(src_dict_size, trg_dict_size, src_lang="en"):
    s, t = _checked(src_dict_size, trg_dict_size, src_lang)
    return _reader_creator("train", s, t, src_lang)


def test(src_dict_size, trg_dict_size, src_lang="en"):
    s, t = _checked(src_dict_size, trg_dict_size, src_lang)
    return _reader_creator("test", s, t, src_lang)


def validation(src_dict_size, trg_dict_size, src_lang="en"):
    s, t = _checked(src_dict_size, trg_dict_size, src_lang)
    return _reader_creator("val", s, t, src_lang)


def get_dict(lang, dict_size, reverse=False):
    dict_size = min(dict_size, (
        TOTAL_EN_WORDS if lang == "en" else TOTAL_DE_WORDS))
    return _load_dict(dict_size, lang, reverse)


def convert(path, src_dict_size, trg_dict_size, src_lang):
    """Convert the dataset to record files (reference wmt16.convert),
    through the native record writer."""
    common.convert(
        path,
        train(src_dict_size=src_dict_size, trg_dict_size=trg_dict_size,
              src_lang=src_lang),
        1000,
        "wmt16_train",
    )
    common.convert(
        path,
        test(src_dict_size=src_dict_size, trg_dict_size=trg_dict_size,
              src_lang=src_lang),
        1000,
        "wmt16_test",
    )
