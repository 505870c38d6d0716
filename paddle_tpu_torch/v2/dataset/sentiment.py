"""Movie-review sentiment reader creators (reference dataset/sentiment.py:
the NLTK movie_reviews corpus — one tokenised review per file under
corpora/movie_reviews/{neg,pos}/cvNNN_NNNNN.txt — word dict sorted by
corpus frequency, neg=0 / pos=1, neg/pos files interleaved then split
1600/400).

Wire format: the NLTK corpus DIRECTORY layout, decoded with a plain
directory walk (no nltk dependency — the reference only used nltk as a
downloader/tokenizer; the on-disk layout is ordinary text files).
fetch() synthesises a REAL-LAYOUT corpus from the deterministic,
polarity-separable pools. API deviation kept from round 1: train()/
test() return reader CREATORS like every other module here (the
reference returns bare iterators — an inconsistency of its own surface).
"""

import collections
import os
from itertools import chain

from . import common

__all__ = ["train", "test", "get_word_dict", "fetch", "convert"]

NUM_TRAINING_INSTANCES = 256
N_PER_CLASS = 160  # 320 files total

_POS_POOL = ["great", "wonderful", "superb", "moving", "delight",
             "masterpiece", "love", "charming"]
_NEG_POOL = ["awful", "boring", "dreadful", "waste", "terrible",
             "clumsy", "hate", "tedious"]
_NEUTRAL = ["the", "movie", "film", "plot", "actor", "scene", "story",
            "director", "screen", "minute"]


def _dir():
    return os.path.join(common.DATA_HOME, "corpora", "movie_reviews")


def _synthetic_docs(polarity):
    rng = common.rng_for("sentiment", polarity)
    pool = _POS_POOL if polarity == "pos" else _NEG_POOL
    for i in range(N_PER_CLASS):
        length = int(rng.randint(6, 30))
        words = [
            pool[rng.randint(len(pool))]
            if rng.rand() < 0.4
            else _NEUTRAL[rng.randint(len(_NEUTRAL))]
            for _ in range(length)
        ]
        yield i, " ".join(words)


def fetch():
    base = _dir()
    for polarity in ("neg", "pos"):
        d = os.path.join(base, polarity)
        os.makedirs(d, exist_ok=True)
        for i, text in _synthetic_docs(polarity):
            path = os.path.join(d, "cv%03d_%05d.txt" % (i, 10000 + i))
            if not os.path.exists(path):
                with open(path + ".tmp", "w") as f:
                    f.write(text + "\n")
                os.replace(path + ".tmp", path)
    return base


def _fileids(polarity):
    d = os.path.join(_dir(), polarity)
    if os.path.isdir(d):
        return ["%s/%s" % (polarity, n) for n in sorted(os.listdir(d))
                if n.endswith(".txt")]
    return ["%s/synth_%d" % (polarity, i) for i in range(N_PER_CLASS)]


_SYNTH = {}


def _words(fileid):
    polarity, name = fileid.split("/", 1)
    path = os.path.join(_dir(), polarity, name)
    if os.path.exists(path):
        with open(path) as f:
            return f.read().lower().split()
    if polarity not in _SYNTH:
        _SYNTH[polarity] = {
            i: text.split() for i, text in _synthetic_docs(polarity)
        }
    idx = int(name.rsplit("_", 1)[-1]) if name.startswith("synth_") else 0
    return _SYNTH[polarity][idx]


def get_word_dict():
    """[(word, id)] sorted by corpus frequency (reference semantics)."""
    freq = collections.defaultdict(int)
    for polarity in ("neg", "pos"):
        for fid in _fileids(polarity):
            for w in _words(fid):
                freq[w] += 1
    ranked = sorted(freq.items(), key=lambda x: (-x[1], x[0]))
    return [(w, i) for i, (w, _) in enumerate(ranked)]


_CACHE = {}


def _load_all():
    # keyed on whether real files exist so a fetch() later in the
    # process invalidates the fallback result
    key = (_dir(), os.path.isdir(os.path.join(_dir(), "pos")))
    if key in _CACHE:
        return _CACHE[key]
    ids = dict(get_word_dict())
    data = []
    # neg/pos interleaved, as the reference's sort_files does
    for fid in chain.from_iterable(zip(_fileids("neg"), _fileids("pos"))):
        label = 0 if fid.startswith("neg") else 1
        data.append(([ids[w] for w in _words(fid)], label))
    _CACHE[key] = data
    return data


def train():
    def reader():
        for sample in _load_all()[:NUM_TRAINING_INSTANCES]:
            yield sample

    return reader


def test():
    def reader():
        for sample in _load_all()[NUM_TRAINING_INSTANCES:]:
            yield sample

    return reader


def convert(path):
    common.convert(path, train(), 128, "sentiment_train")
    common.convert(path, test(), 128, "sentiment_test")
