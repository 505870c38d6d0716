"""PTB (imikolov) reader creators (reference dataset/imikolov.py:
simple-examples.tgz -> ptb.train.txt / ptb.valid.txt, build_dict by
frequency with <unk> last, n-gram readers over <s> sentence <e>).

Wire format: `simple-examples.tgz` — a tar containing
`./simple-examples/data/ptb.train.txt` and `ptb.valid.txt`, one
tokenised sentence per line (exactly the Mikolov PTB layout the
reference extracts, imikolov.py:55,77). Real files are decoded; fetch()
synthesises REAL-FORMAT files from the deterministic corpus.

build_dict(min_word_freq): count words of train+valid (plus <s>/<e>),
keep freq > threshold, sort by (-freq, word), ids 0..; '<unk>' gets the
last id — reference semantics exactly.
"""

import collections
import io
import os
import tarfile

from . import common

__all__ = ["train", "test", "build_dict", "fetch", "convert", "DataType"]

_TRAIN_MEMBER = "./simple-examples/data/ptb.train.txt"
_VALID_MEMBER = "./simple-examples/data/ptb.valid.txt"
N_TRAIN, N_VALID = 1024, 256


class DataType(object):
    NGRAM = 1
    SEQ = 2


def _path():
    return os.path.join(common.DATA_HOME, "imikolov", "simple-examples.tgz")


def _vocab_words():
    # zipf-ish vocabulary: low ids appear often (clear the reference's
    # default min_word_freq=50 bar), tail ids map to <unk>
    return ["w%03d" % i for i in range(160)]


def _synthetic_sentences(split, n):
    rng = common.rng_for("imikolov", split)
    words = _vocab_words()
    for _ in range(n):
        length = int(rng.randint(5, 18))
        ids = (rng.zipf(1.35, size=length) - 1) % len(words)
        # learnable structure: every other word follows its predecessor
        ids[1::2] = (ids[:-1:2] + 1) % len(words)
        yield " ".join(words[i] for i in ids)


def fetch():
    path = _path()
    if os.path.exists(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with tarfile.open(tmp, "w:gz") as tf:
        for member, split, n in (
            (_TRAIN_MEMBER, "train", N_TRAIN),
            (_VALID_MEMBER, "test", N_VALID),
        ):
            blob = "\n".join(_synthetic_sentences(split, n)).encode() + b"\n"
            info = tarfile.TarInfo(member)
            info.size = len(blob)
            tf.addfile(info, io.BytesIO(blob))
    os.replace(tmp, path)
    return path


def _lines(split):
    """Decode the tar member when cached, else the in-memory corpus."""
    member = _TRAIN_MEMBER if split == "train" else _VALID_MEMBER
    n = N_TRAIN if split == "train" else N_VALID
    path = _path()
    if os.path.exists(path):
        with tarfile.open(path) as tf:
            f = tf.extractfile(member)
            for raw in f.read().decode().splitlines():
                yield raw
    else:
        for line in _synthetic_sentences(split, n):
            yield line


def word_count(lines, word_freq=None):
    if word_freq is None:
        word_freq = collections.defaultdict(int)
    for l in lines:
        for w in l.strip().split():
            word_freq[w] += 1
        word_freq["<s>"] += 1
        word_freq["<e>"] += 1
    return word_freq


def build_dict(min_word_freq=50):
    word_freq = word_count(_lines("test"), word_count(_lines("train")))
    word_freq.pop("<unk>", None)
    return common.ranked_vocab(word_freq, min_word_freq)


def _reader_creator(split, word_idx, n, data_type):
    def reader():
        UNK = word_idx["<unk>"]
        for line in _lines(split):
            toks = ["<s>"] + line.strip().split() + ["<e>"]
            if data_type == DataType.NGRAM:
                if n <= 0:
                    raise ValueError("invalid gram length %d" % n)
                if len(toks) >= n:
                    ids = [word_idx.get(w, UNK) for w in toks]
                    for i in range(n, len(ids) + 1):
                        yield tuple(ids[i - n:i])
            elif data_type == DataType.SEQ:
                ids = [word_idx.get(w, UNK) for w in toks]
                yield ids[:-1], ids[1:]
            else:
                raise ValueError("unknown data type %r" % data_type)

    return reader


def train(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("train", word_idx, n, data_type)


def test(word_idx, n, data_type=DataType.NGRAM):
    return _reader_creator("test", word_idx, n, data_type)


def convert(path):
    word_idx = build_dict()
    common.convert(path, train(word_idx, 5), 512, "imikolov_train")
    common.convert(path, test(word_idx, 5), 512, "imikolov_test")
