"""CoNLL-2005 SRL reader creators (reference dataset/conll05.py:
conll05st-tests.tar.gz holding `conll05st-release/test.wsj/words/
test.wsj.words.gz` (one token per line, blank line between sentences)
and `.../props/test.wsj.props.gz` (per line: predicate-lemma column +
one bracket-label column per predicate — `(A0*`, `*`, `*)`, `(V*)` ...);
plus wordDict.txt / verbDict.txt / targetDict.txt files loaded by line
number. The bracket columns convert to B-/I-/O tag sequences and each
predicate yields one 9-field sample: word ids, 5 predicate-context
columns (bos/eos padded), predicate id, context mark, label ids —
conll05.py:132-178 semantics with UNK_IDX=0.

fetch() synthesises REAL-FORMAT files (tarball with gzipped members,
dict text files, f32 embedding blob) from the deterministic corpus;
real downloads decode through the same parser.
"""

import gzip
import io
import itertools
import os
import tarfile

from . import common

__all__ = ["get_dict", "get_embedding", "test", "fetch", "convert"]

UNK_IDX = 0
_WORDS_MEMBER = "conll05st-release/test.wsj/words/test.wsj.words.gz"
_PROPS_MEMBER = "conll05st-release/test.wsj/props/test.wsj.props.gz"
N_SENTENCES = 128
_WORD_POOL = ["w%02d" % i for i in range(80)]
_VERBS = ["say", "make", "take", "give", "find", "tell", "ask", "keep",
          "show", "hold", "bring", "begin", "move", "play", "run"]
_ROLES = ["A0", "A1", "A2", "AM-TMP"]
EMB_DIM = 32


def _cache(name):
    return os.path.join(common.DATA_HOME, "conll05st", name)


def _synthetic_sentences():
    """(words, lemma, verb position, B-/I-/O tags); the writer encodes
    the tags into bracket notation and the parser must round-trip."""
    rng = common.rng_for("conll05", "test")
    out = []
    for _ in range(N_SENTENCES):
        L = int(rng.randint(4, 12))
        words = [_WORD_POOL[rng.randint(len(_WORD_POOL))] for _ in range(L)]
        v = int(rng.randint(1, L - 1))
        lemma = _VERBS[rng.randint(len(_VERBS))]
        words[v] = lemma
        tags = ["O"] * L
        tags[v] = "B-V"
        # an A0 span somewhere before the verb
        a0_end = int(rng.randint(0, v))
        a0_start = int(rng.randint(0, a0_end + 1))
        for i in range(a0_start, a0_end + 1):
            tags[i] = "B-A0" if i == a0_start else "I-A0"
        # a second role span after the verb, when room remains
        if v + 2 < L:
            role = _ROLES[1:][int(rng.randint(3))]
            a1_start = v + 1 + int(rng.randint(0, L - v - 2))
            a1_end = a1_start + int(rng.randint(0, L - a1_start))
            for i in range(a1_start, a1_end + 1):
                tags[i] = ("B-" + role) if i == a1_start else ("I-" + role)
        out.append((words, lemma, v, tags))
    return out


def _encode_brackets(tags):
    """B-/I-/O -> the props bracket column (inverse of the reference's
    decoding state machine)."""
    col = []
    for i, t in enumerate(tags):
        nxt = tags[i + 1] if i + 1 < len(tags) else "O"
        same_continues = nxt.startswith("I-") and (
            t[2:] == nxt[2:] if t != "O" else False
        )
        if t == "O":
            col.append("*")
        elif t.startswith("B-"):
            tag = t[2:]
            col.append("(%s*" % tag if same_continues else "(%s*)" % tag)
        else:  # I- : continue or close the open span
            col.append("*" if same_continues else "*)")
    return col


def _dict_words():
    return ["<unk>"] + sorted(set(_WORD_POOL) | set(_VERBS)) + \
        ["bos", "eos"]


def _label_entries():
    labels = ["O"]
    for r in _ROLES + ["V"]:
        labels += ["B-" + r, "I-" + r]
    return labels


def fetch():
    d = os.path.dirname(_cache("x"))
    os.makedirs(d, exist_ok=True)
    for name, entries in (
        ("wordDict.txt", _dict_words()),
        ("verbDict.txt", sorted(_VERBS)),
        ("targetDict.txt", _label_entries()),
    ):
        path = _cache(name)
        if not os.path.exists(path):
            with open(path + ".tmp", "w") as f:
                f.write("\n".join(entries) + "\n")
            os.replace(path + ".tmp", path)
    # embedding blob: [n_words, EMB_DIM] f32 (the reference ships a
    # pretrained binary; here deterministic random)
    emb_path = _cache("emb")
    if not os.path.exists(emb_path):
        import numpy as np

        rng = common.rng_for("conll05", "emb")
        arr = rng.randn(len(_dict_words()), EMB_DIM).astype("<f4")
        with open(emb_path + ".tmp", "wb") as f:
            f.write(arr.tobytes())
        os.replace(emb_path + ".tmp", emb_path)
    tar_path = _cache("conll05st-tests.tar.gz")
    if not os.path.exists(tar_path):
        words_lines, props_lines = [], []
        for words, lemma, v, tags in _synthetic_sentences():
            col = _encode_brackets(tags)
            for i, w in enumerate(words):
                words_lines.append(w)
                props_lines.append(
                    "%s %s" % (lemma if i == v else "-", col[i]))
            words_lines.append("")
            props_lines.append("")
        with tarfile.open(tar_path + ".tmp", "w:gz") as tf:
            for member, lines in ((_WORDS_MEMBER, words_lines),
                                  (_PROPS_MEMBER, props_lines)):
                blob = io.BytesIO()
                with gzip.GzipFile(fileobj=blob, mode="wb") as gz:
                    gz.write(("\n".join(lines) + "\n").encode())
                data = blob.getvalue()
                info = tarfile.TarInfo(member)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
        os.replace(tar_path + ".tmp", tar_path)
    return d


def load_dict(filename):
    d = {}
    with open(filename) as f:
        for i, line in enumerate(f):
            d[line.strip()] = i
    return d


def get_dict():
    """(word_dict, verb_dict, label_dict) from the dict files (reference
    get_dict); synthesised via fetch() when absent."""
    fetch()  # idempotent per artifact; heals a partially-written cache
    return (load_dict(_cache("wordDict.txt")),
            load_dict(_cache("verbDict.txt")),
            load_dict(_cache("targetDict.txt")))


def get_embedding():
    """Path to the [n_words, EMB_DIM] f32 embedding blob (reference
    returns the downloaded file path)."""
    if not os.path.exists(_cache("emb")):
        fetch()
    return _cache("emb")


def corpus_reader(data_path=None, words_name=_WORDS_MEMBER,
                  props_name=_PROPS_MEMBER):
    """Yield (sentence words, predicate lemma, B-/I-/O labels) per
    predicate column — the reference corpus_reader bracket decoding."""
    data_path = data_path or _cache("conll05st-tests.tar.gz")
    if not os.path.exists(data_path):
        fetch()

    def _decode_column(col):
        """One bracket column -> B-/I-/O tags. Grammar: '(TAG*' opens a
        span, '*' continues it (or is O outside one), '*)' closes it,
        '(TAG*)' is a single-token span."""
        tags, span = [], None
        for tok in col:
            if tok.startswith("("):
                tag = tok[1:tok.index("*")]
                tags.append("B-" + tag)
                span = None if tok.endswith(")") else tag
            elif tok == "*)":
                tags.append("I-" + (span or "O"))
                span = None
            elif tok == "*":
                tags.append("I-" + span if span else "O")
            else:
                raise RuntimeError("unexpected props token: %s" % tok)
        return tags

    def _sentences():
        """Group the parallel line streams into per-sentence
        (words, prop rows) chunks at blank lines."""
        with tarfile.open(data_path) as tf:
            wf = tf.extractfile(words_name)
            pf = tf.extractfile(props_name)
            with gzip.GzipFile(fileobj=wf) as words_file, \
                    gzip.GzipFile(fileobj=pf) as props_file:
                words, rows = [], []
                for wline, pline in itertools.zip_longest(words_file,
                                                          props_file):
                    w = wline.decode().strip()
                    row = pline.decode().strip().split()
                    if not row:  # sentence boundary
                        if rows:
                            yield words, rows
                        words, rows = [], []
                    else:
                        words.append(w)
                        rows.append(row)
                if rows:
                    yield words, rows

    def reader():
        for words, rows in _sentences():
            lemma_col = [r[0] for r in rows]
            predicates = [x for x in lemma_col if x != "-"]
            n_preds = len(rows[0]) - 1
            for k in range(n_preds):
                col = [r[1 + k] for r in rows]
                yield words, predicates[k], _decode_column(col)

    return reader


def reader_creator(corpus_reader, word_dict=None, predicate_dict=None,
                   label_dict=None):
    # context-window offsets and their out-of-range padding tokens: the
    # reference marks the 5-token window around the predicate and pads
    # positions that fall off the sentence with 'bos'/'eos'
    # (conll05.py:135-162)
    offsets = ((-2, "bos"), (-1, "bos"), (0, None), (1, "eos"), (2, "eos"))

    def reader():
        for sentence, predicate, labels in corpus_reader():
            n = len(sentence)
            v = labels.index("B-V")
            mark = [0] * n
            ctx_cols = []
            for off, pad in offsets:
                ok = 0 <= v + off < n
                if ok:
                    mark[v + off] = 1
                word = sentence[v + off] if ok else pad
                ctx_cols.append([word_dict.get(word, UNK_IDX)] * n)

            yield tuple(
                [[word_dict.get(w, UNK_IDX) for w in sentence]]
                + ctx_cols
                + [[predicate_dict.get(predicate)] * n, mark,
                   [label_dict.get(t) for t in labels]]
            )

    return reader


def test():
    word_dict, verb_dict, label_dict = get_dict()
    return reader_creator(
        corpus_reader(),
        word_dict=word_dict,
        predicate_dict=verb_dict,
        label_dict=label_dict,
    )


def convert(path):
    common.convert(path, test(), 128, "conll05_test")
