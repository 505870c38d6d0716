"""Criteo display-advertising CTR reader creators — the data side of the
wide&deep/DeepFM workload (models/ctr.py). The reference era served this
model class through the sparse pserver path (row-sharded tables,
RemoteParameterUpdater.h:265); here the tables row-shard over the mesh
(parallel/embedding.py) and this module supplies the classic wire format.

Wire format (Criteo Display Advertising Challenge TSV, the canonical CTR
benchmark): each line is

  label \\t I1..I13 (integer counts, may be empty) \\t C1..C26 (8-hex-char
  categorical hashes, may be empty)

gzip-wrapped under ``DATA_HOME/criteo``. Real files placed there are
DECODED; ``fetch()`` synthesises REAL-FORMAT files from the deterministic
corpus (nothing is downloaded), so the decode path is exercised either way.
Without cached files the readers fall back to the in-memory corpus.

Readers yield ``(dense, ids, label)``:
  dense  — float32[13], log1p-scaled integer features (missing -> 0)
  ids    — int64[26], each categorical token bucket-hashed into its
           field's disjoint id range: id = field*buckets + crc32(tok)%buckets
  label  — int, 0/1 click
"""

import gzip
import os
import zlib

import numpy as np

from . import common

__all__ = ["train", "test", "fetch", "convert", "vocab_size",
           "NUM_DENSE", "NUM_SPARSE"]

NUM_DENSE = 13
NUM_SPARSE = 26
N_TRAIN, N_TEST = 512, 128
_FILES = {"train": "train.txt.gz", "test": "test.txt.gz"}


def vocab_size(buckets_per_field=1000):
    """Total id space across the 26 disjoint per-field ranges — the
    [vocab] for models.ctr tables."""
    return NUM_SPARSE * int(buckets_per_field)


def _cache_dir():
    return os.path.join(common.DATA_HOME, "criteo")


def _synthetic_lines(split, n):
    """Deterministic corpus in the REAL TSV schema. Click probability
    depends on C1/C2 parity so CTR models have signal to learn."""
    rng = common.rng_for("criteo", split)
    for _ in range(n):
        ints = [
            "" if rng.rand() < 0.1 else str(int(rng.poisson(3.0)))
            for _ in range(NUM_DENSE)
        ]
        cats = [
            "" if rng.rand() < 0.05 else "%08x" % rng.randint(0, 1 << 20)
            for _ in range(NUM_SPARSE)
        ]
        sig = (zlib.crc32(cats[0].encode()) ^ zlib.crc32(cats[1].encode())) & 1
        label = int(sig ^ (rng.rand() < 0.15))
        yield "\t".join([str(label)] + ints + cats)


def _write_gz(split, n, path):
    if os.path.exists(path):
        return  # never clobber genuine downloads
    tmp = path + ".tmp"
    with gzip.open(tmp, "wt") as f:
        for line in _synthetic_lines(split, n):
            f.write(line + "\n")
    os.replace(tmp, path)


def fetch():
    os.makedirs(_cache_dir(), exist_ok=True)
    _write_gz("train", N_TRAIN, os.path.join(_cache_dir(), _FILES["train"]))
    _write_gz("test", N_TEST, os.path.join(_cache_dir(), _FILES["test"]))


def _parse(line, buckets):
    parts = line.rstrip("\n").split("\t")
    if len(parts) == NUM_DENSE + NUM_SPARSE:
        # the canonical Kaggle test split carries no label column;
        # yield -1 so held-out data still decodes
        parts = ["-1"] + parts
    if len(parts) != 1 + NUM_DENSE + NUM_SPARSE:
        raise ValueError(
            "criteo line has %d fields, want %d (labeled) or %d"
            % (len(parts), 1 + NUM_DENSE + NUM_SPARSE,
               NUM_DENSE + NUM_SPARSE)
        )
    label = int(parts[0])
    dense = np.zeros(NUM_DENSE, np.float32)
    for i, tok in enumerate(parts[1:1 + NUM_DENSE]):
        if tok:
            dense[i] = np.log1p(max(int(tok), 0))
    ids = np.empty(NUM_SPARSE, np.int64)
    for i, tok in enumerate(parts[1 + NUM_DENSE:]):
        ids[i] = i * buckets + (zlib.crc32(tok.encode()) % buckets)
    return dense, ids, label


def _reader_creator(split, n, buckets):
    def reader():
        path = os.path.join(_cache_dir(), _FILES[split])
        if os.path.exists(path):
            with gzip.open(path, "rt") as f:
                for line in f:
                    yield _parse(line, buckets)
        else:
            for line in _synthetic_lines(split, n):
                yield _parse(line, buckets)

    return reader


def train(buckets_per_field=1000):
    return _reader_creator("train", N_TRAIN, int(buckets_per_field))


def test(buckets_per_field=1000):
    return _reader_creator("test", N_TEST, int(buckets_per_field))


def convert(path, buckets_per_field=1000):
    common.convert(path, train(buckets_per_field), 256, "criteo_train")
    common.convert(path, test(buckets_per_field), 256, "criteo_test")
