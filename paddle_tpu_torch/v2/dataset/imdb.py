"""IMDB sentiment reader creators (reference dataset/imdb.py:
aclImdb_v1.tar.gz -> aclImdb/{train,test}/{pos,neg}/*.txt, tokenize by
lowercase + punctuation strip, build_dict by frequency with <unk> last,
readers yield (word-id list, label) with POS=0 / NEG=1 — the reference's
label convention, imdb.py:83).

Wire format: the real Stanford tarball layout — one review per .txt
member under the four split/polarity directories. Real files are
decoded; fetch() synthesises a REAL-FORMAT tarball from the
deterministic corpus (polarity-correlated word pools so sentiment is
learnable), exercising the tar/tokenize path either way.
"""

import collections
import io
import os
import re
import string
import tarfile

from . import common

__all__ = ["build_dict", "word_dict", "train", "test", "fetch", "convert"]

# genuine-download checksum (reference dataset/imdb.py:32)
MD5 = "7c2ac02c03563afcf9b574c7e56c153a"

N_TRAIN, N_TEST = 256, 64  # reviews per split (half pos, half neg)

_POS_POOL = ["great", "wonderful", "superb", "moving", "delight",
             "masterpiece", "love", "charming", "beautiful", "perfect"]
_NEG_POOL = ["awful", "boring", "dreadful", "waste", "terrible",
             "clumsy", "hate", "tedious", "flat", "mess"]
_NEUTRAL = ["the", "movie", "film", "plot", "actor", "scene", "story",
            "director", "screen", "minute", "character", "music",
            "camera", "dialog", "ending", "beginning"]


def _path():
    return os.path.join(common.DATA_HOME, "imdb", "aclImdb_v1.tar.gz")


def _synthetic_reviews(split):
    n = N_TRAIN if split == "train" else N_TEST
    rng = common.rng_for("imdb", split)
    for i in range(n):
        label = i % 2  # 0 = pos, 1 = neg (reference convention)
        pool = _POS_POOL if label == 0 else _NEG_POOL
        length = int(rng.randint(8, 40))
        words = [
            pool[rng.randint(len(pool))]
            if rng.rand() < 0.4
            else _NEUTRAL[rng.randint(len(_NEUTRAL))]
            for _ in range(length)
        ]
        # real-review dressing the tokenizer must strip
        text = " ".join(words).capitalize() + "."
        yield label, i, text


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with tarfile.open(tmp, "w:gz") as tf:
        for split in ("train", "test"):
            for label, i, text in _synthetic_reviews(split):
                polarity = "pos" if label == 0 else "neg"
                blob = text.encode()
                info = tarfile.TarInfo(
                    "aclImdb/%s/%s/%d_%d.txt"
                    % (split, polarity, i, 7 if label == 0 else 2)
                )
                info.size = len(blob)
                tf.addfile(info, io.BytesIO(blob))
    os.replace(tmp, path)
    return path


_PUNCT = str.maketrans("", "", string.punctuation)


def _tok(text):
    return text.rstrip("\n\r").translate(_PUNCT).lower().split()


def tokenize(pattern):
    """Yield tokenised docs whose tar member name matches `pattern`
    (reference imdb.py:64 tokenize — sequential tar access). The
    no-tarball fallback synthesises the member NAMES and applies the
    same pattern, so broad patterns (e.g. the whole train split) see
    both polarities exactly as the decoded path would."""
    path = _path()
    if os.path.exists(path):
        with tarfile.open(path) as tarf:
            tf = tarf.next()
            while tf is not None:
                if pattern.match(tf.name):
                    yield _tok(tarf.extractfile(tf).read().decode())
                tf = tarf.next()
    else:
        for split in ("train", "test"):
            for label, i, text in _synthetic_reviews(split):
                polarity = "pos" if label == 0 else "neg"
                name = "aclImdb/%s/%s/%d_%d.txt" % (
                    split, polarity, i, 7 if label == 0 else 2)
                if pattern.match(name):
                    yield _tok(text)


def build_dict(pattern, cutoff):
    """Frequency dictionary over docs matching `pattern`; <unk> last."""
    word_freq = collections.defaultdict(int)
    for doc in tokenize(pattern):
        for word in doc:
            word_freq[word] += 1
    return common.ranked_vocab(word_freq, cutoff)


def word_dict():
    """Reference convenience: dictionary over the whole training set."""
    return build_dict(re.compile(r"aclImdb/train/.*\.txt$"), 0)


def _reader_creator(pos_pattern, neg_pattern, word_idx):
    UNK = word_idx["<unk>"]

    def load(pattern, out, label):
        for doc in tokenize(pattern):
            out.append(([word_idx.get(w, UNK) for w in doc], label))

    ins = []
    load(pos_pattern, ins, 0)
    load(neg_pattern, ins, 1)

    def reader():
        for doc, label in ins:
            yield doc, label

    return reader


def train(word_idx):
    return _reader_creator(
        re.compile(r"aclImdb/train/pos/.*\.txt$"),
        re.compile(r"aclImdb/train/neg/.*\.txt$"), word_idx)


def test(word_idx):
    return _reader_creator(
        re.compile(r"aclImdb/test/pos/.*\.txt$"),
        re.compile(r"aclImdb/test/neg/.*\.txt$"), word_idx)


def convert(path):
    w = word_dict()
    common.convert(path, train(w), 128, "imdb_train")
    common.convert(path, test(w), 128, "imdb_test")
