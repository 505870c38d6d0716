"""MQ2007 (LETOR 4.0) learning-to-rank reader creators (reference
dataset/mq2007.py: Fold1/train.txt + test.txt parsed into per-query
groups; format = 'pointwise' | 'pairwise' | 'listwise').

Wire format: the LETOR svmlight-style line the reference's
load_from_text parses —

  rel qid:NN 1:v 2:v ... 46:v #docid = GX000-.. inc = 1 prob = 0.5

46 dense features per query-document pair, queries contiguous by qid.
Real files placed under DATA_HOME/MQ2007/MQ2007/Fold1/ are decoded;
fetch() synthesises REAL-FORMAT files from the deterministic corpus.
(The genuine distribution ships as a .rar; no rar extractor exists in
this image, so fetch() writes the extracted layout directly — the LINE
format, the part that carries semantics, is exact.)
"""

import os

import numpy as np

from . import common

__all__ = ["train", "test", "fetch", "NUM_FEATURES"]

NUM_FEATURES = 46
N_TRAIN_QUERIES, N_TEST_QUERIES = 64, 16


def _dir():
    return os.path.join(common.DATA_HOME, "MQ2007", "MQ2007", "Fold1")


def _synthetic_queries(split, n):
    rng = common.rng_for("mq2007", split)
    for qid in range(n):
        n_docs = int(rng.randint(2, 6))
        feats = rng.rand(n_docs, NUM_FEATURES).astype("float32")
        rels = rng.randint(0, 3, n_docs)
        yield qid + 1, feats, rels


def fetch():
    d = _dir()
    os.makedirs(d, exist_ok=True)
    for split, n in (("train", N_TRAIN_QUERIES), ("test", N_TEST_QUERIES)):
        path = os.path.join(d, "%s.txt" % split)
        if os.path.exists(path):
            continue
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            for qid, feats, rels in _synthetic_queries(split, n):
                for j in range(feats.shape[0]):
                    cols = " ".join(
                        "%d:%.6f" % (k + 1, feats[j, k])
                        for k in range(NUM_FEATURES)
                    )
                    f.write(
                        "%d qid:%d %s #docid = GX%03d-00-%07d inc = 1 "
                        "prob = 0.5\n" % (rels[j], qid, cols, qid, j)
                    )
        os.replace(tmp, path)
    return d


def _parse_line(line):
    head, _, _ = line.partition("#")
    parts = head.split()
    rel = int(parts[0])
    qid = int(parts[1].split(":")[1])
    feats = np.full(NUM_FEATURES, -1.0, "float32")  # LETOR missing = -1
    for tok in parts[2:]:
        k, _, v = tok.partition(":")
        feats[int(k) - 1] = float(v)
    return qid, rel, feats


def _queries(split, n):
    """Per-query (feats [n_docs, 46], rels [n_docs]) groups, decoded from
    the cached file when present."""
    path = os.path.join(_dir(), "%s.txt" % split)
    if os.path.exists(path):
        cur_qid, feats, rels = None, [], []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                qid, rel, fv = _parse_line(line)
                if cur_qid is not None and qid != cur_qid:
                    yield np.stack(feats), np.asarray(rels)
                    feats, rels = [], []
                cur_qid = qid
                feats.append(fv)
                rels.append(rel)
        if feats:
            yield np.stack(feats), np.asarray(rels)
    else:
        for _, feats, rels in _synthetic_queries(split, n):
            yield feats, rels


def _reader(split, n, format):
    def reader():
        for feats, rels in _queries(split, n):
            if format == "pointwise":
                for f, r in zip(feats, rels):
                    yield f, int(r)
            elif format == "pairwise":
                for i in range(len(rels)):
                    for j in range(len(rels)):
                        if rels[i] > rels[j]:
                            yield feats[i], feats[j]
            else:  # listwise
                yield feats, rels.astype("int64")

    return reader


def train(format="pairwise"):
    return _reader("train", N_TRAIN_QUERIES, format)


def test(format="pairwise"):
    return _reader("test", N_TEST_QUERIES, format)
