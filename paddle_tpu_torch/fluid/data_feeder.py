"""DataFeeder: minibatch rows -> feed dict (counterpart of
paddle_tpu/fluid/data_feeder.py; reference
python/paddle/v2/fluid/data_feeder.py). Dense slots stack to one array;
lod_level-1 slots pack to `(data [total, ...], [offsets])` pairs, the
Executor's ragged feed (core/kernels_sequence.py). Integer slots keep
their declared width (the port's Executor runs int64 ids as int64);
float64 narrows to float32. `AsyncDeviceFeeder` uploads feed dicts to
the card from a background thread, ahead of the training loop, through
`HostToDevice`, the upload `data.DataLoader` takes too."""

from __future__ import annotations

import queue
import threading
import warnings

import numpy as np
import torch

from .core.program import Variable

__all__ = ["DataFeeder", "AsyncDeviceFeeder", "HostToDevice"]

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
                    "DataFeeder packs lod_level 0 and 1 slots, as the JAX "
                    "package's does; feed a nested (2-level) sequence as "
                    "a (data, [outer, finest]) pair to Executor.run")
        return out

    def feed_iter(self, batches):
        """Feed dicts from an iterable of row batches (each a list of
        row tuples, exactly what feed() takes). Compose with
        AsyncDeviceFeeder for the upload overlap:

            for feed in AsyncDeviceFeeder(feeder.feed_iter(batches)):
                exe.run(prog, feed=feed, fetch_list=[loss])
        """
        for rows in batches:
            yield self.feed(rows)


def _map_arrays(fn, tree):
    """`tree` with `fn` applied to every numpy array and tensor in it,
    through tuples, lists and dicts; other leaves stay as they are."""
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return fn(tree)
    if isinstance(tree, tuple):
        return tuple(_map_arrays(fn, v) for v in tree)
    if isinstance(tree, list):
        return [_map_arrays(fn, v) for v in tree]
    if isinstance(tree, dict):
        return {k: _map_arrays(fn, v) for k, v in tree.items()}
    return tree


class HostToDevice(object):
    """The port's one host->device upload of input batches, shared by
    `AsyncDeviceFeeder` and `data.DataLoader`. It has two halves, one
    for each side of a producer/consumer queue:

      upload(tree) -> (tree, ready)   producer side: every numpy array
                                      and tensor in `tree` (through
                                      tuples, lists and dicts) is copied
                                      to `device`
      take(tree, ready) -> tree       consumer side, before the batch
                                      is used

    On the card `upload` copies each array into fresh pinned memory
    (a tensor already pinned is taken as it is) and uploads it with
    `non_blocking=True` on a side stream of its own, recording the
    event `ready` after the copies. The caching host allocator keeps a
    pinned block until the copy that reads it is done, so no host
    buffer is reused in flight. `take` makes the consumer's current
    stream wait on `ready` and records each uploaded tensor on that
    stream, so the caching device allocator does not hand its memory
    out again before the consumer's kernels that read it have run.
    Elsewhere (`CPUPlace()`) each array becomes a tensor with a buffer
    of its own, and `ready` is None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self.cuda \
            else None

    def _to_device(self, v):
        if isinstance(v, np.ndarray):
            if not self.cuda:
                return torch.from_numpy(np.array(v))  # an array of its own
            a = np.ascontiguousarray(v)
            v = torch.from_numpy(a if a.flags.writeable else a.copy())
        if not self.cuda:
            return v.to(self.device)
        if not v.is_cuda and not v.is_pinned():
            v = v.pin_memory()
        return v.to(self.device, non_blocking=True)

    def upload(self, tree):
        if not self.cuda:
            return _map_arrays(self._to_device, tree), None
        with torch.cuda.device(self.device), torch.cuda.stream(
                self._stream):
            out = _map_arrays(self._to_device, tree)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def take(self, tree, ready):
        if ready is None:
            return tree
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(ready)

        def _record(t):
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t.record_stream(consumer)
            return t

        _map_arrays(_record, tree)
        return tree


def _is_lod_pair(v) -> bool:
    return isinstance(v, tuple) and len(v) == 2 and not np.isscalar(v[0])


class AsyncDeviceFeeder(object):
    """Host->device double buffering (counterpart of the JAX package's
    AsyncDeviceFeeder; the reference's double-buffered DataProvider,
    paddle/gserver/dataproviders/DataProvider.h DoubleBuffer): a
    background thread pulls feed dicts from an iterator and uploads every
    array to the device AHEAD of the training loop, so the upload of
    batch k+1 overlaps the device work of batch k::

        feeder = AsyncDeviceFeeder(feed_iter, capacity=2)
        for feed in feeder:            # feed dicts, tensors on the card
            exe.run(prog, feed=feed, fetch_list=[loss])

    The producer thread uploads each feed dict through `HostToDevice`
    (pinned memory, a side stream, an event the consumer's stream waits
    on before the dict is handed out), so the executor reads each
    tensor (with no second copy: it is on its device already) only
    after its upload. A ragged `(data, lod)` feed keeps its offsets on
    the host. `upload=False` keeps every array on the host, still
    overlapping the reading.

    `place` is where the feeds go: the card unless the caller names
    another (`CPUPlace()` makes CPU tensors). The iterator ends when
    `feed_iter` does; exceptions of the source re-raise at the consumer;
    `close()` stops early and drains."""

    _END = object()

    def __init__(self, feed_iter, capacity: int = 2, upload: bool = True,
                 place=None):
        from . import core

        self._q = queue.Queue(maxsize=max(1, int(capacity)))
        self._stop = threading.Event()
        self._done = False  # terminal: END/exception delivered or closed
        self._h2d = HostToDevice(core.place_device(place)) if upload \
            else None
        self.device = self._h2d.device if upload else None

        def _upload(feed):
            # (data, lod) feeds upload their data; the offsets stay on
            # the host
            arrays = {k: (v[0] if _is_lod_pair(v) else v)
                      for k, v in feed.items()}
            arrays, ready = self._h2d.upload(arrays)
            return ({k: ((arrays[k], v[1]) if _is_lod_pair(v)
                         else arrays[k]) for k, v in feed.items()}, ready)

        def _producer():
            try:
                for feed in feed_iter:
                    if self._stop.is_set():
                        return
                    self._q.put(_upload(feed) if upload
                                else (dict(feed), None))
                self._q.put(self._END)
            except BaseException as e:  # surface in the consumer
                self._q.put(e)

        self._thread = threading.Thread(target=_producer, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._done:
                raise StopIteration
            if self._stop.is_set():
                # closed: drain what's left, then stop — never block on
                # a producer that has already been told to quit
                try:
                    item = self._q.get_nowait()
                except queue.Empty:
                    raise StopIteration
            else:
                item = self._q.get()
            if item is self._END:
                self._done = True  # terminal: later next() must not block
                raise StopIteration
            if isinstance(item, BaseException):
                self._done = True
                raise item
            feed, ready = item
            if ready is not None:
                feed = self._h2d.take(feed, ready)
            return feed

    def close(self):
        self._stop.set()
        self._done = True

        def _drain():
            try:
                while True:
                    item = self._q.get_nowait()
                    if isinstance(item, BaseException):
                        # a real data-source error must not vanish just
                        # because the consumer exited for another reason
                        warnings.warn(
                            "AsyncDeviceFeeder.close() discarded a "
                            "pending reader error: %r" % item)
            except queue.Empty:
                pass

        # a producer blocked in put() completes that put once the drain
        # frees a slot and only THEN sees _stop: drain, wait for the
        # thread to exit, drain the stragglers
        _drain()
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            warnings.warn(
                "AsyncDeviceFeeder producer still blocked in the data "
                "source after close(); its prefetched buffers stay alive "
                "until the read returns")
        _drain()
