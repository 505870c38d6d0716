"""DataFeeder: minibatch rows -> feed dict (counterpart of
paddle_tpu/fluid/data_feeder.py; reference
python/paddle/v2/fluid/data_feeder.py). Dense slots stack to one array;
lod_level-1 slots pack to `(data [total, ...], [offsets])` pairs, the
Executor's ragged feed (core/kernels_sequence.py). Integer slots keep
their declared width (the port's Executor runs int64 ids as int64);
float64 narrows to float32. `AsyncDeviceFeeder` is not ported yet
(ROADMAP Queue A)."""

from __future__ import annotations

import numpy as np

from .core.program import Variable

__all__ = ["DataFeeder"]

_DTYPE_MAP = {"float64": "float32"}


class DataFeeder(object):
    def __init__(self, feed_list, place=None, program=None):
        self.feed_list = []
        for v in feed_list:
            if isinstance(v, str):
                from .core.program import default_main_program

                v = (program or default_main_program()).global_block().var(v)
            if not isinstance(v, Variable):
                raise TypeError("feed_list must contain Variables or names")
            self.feed_list.append(v)
        self.place = place

    def feed(self, iterable):
        rows = list(iterable)
        out = {}
        for i, var in enumerate(self.feed_list):
            col = [row[i] for row in rows]
            dtype = _DTYPE_MAP.get(var.dtype, var.dtype)
            if var.lod_level == 0:
                arr = np.asarray(col, dtype=dtype)
                shape = var.shape
                if shape is not None:
                    # re-shape flat rows into the declared [-1, ...] shape
                    tail = [s for s in shape[1:]]
                    if all(s != -1 for s in tail) and arr.ndim <= 2:
                        arr = arr.reshape([len(rows)] + tail)
                out[var.name] = arr
            elif var.lod_level == 1:
                seqs = [np.asarray(s, dtype=dtype) for s in col]
                lens = [len(s) for s in seqs]
                offsets = np.cumsum([0] + lens).astype(np.int32)
                if seqs and seqs[0].ndim == 1:
                    data = np.concatenate(seqs).reshape(-1, 1)
                else:
                    data = np.concatenate(seqs, axis=0)
                out[var.name] = (data, [offsets.tolist()])
            else:
                raise NotImplementedError(
                    "lod_level>=2 feeds (nested sequences) come with "
                    "control flow (ROADMAP Queue A 6.2)")
        return out

    def feed_iter(self, batches):
        """Feed dicts from an iterable of row batches (each a list of
        row tuples, exactly what feed() takes)."""
        for rows in batches:
            yield self.feed(rows)
