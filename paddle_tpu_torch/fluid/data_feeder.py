"""DataFeeder: minibatch rows -> feed dict (counterpart of
paddle_tpu/fluid/data_feeder.py; reference
python/paddle/v2/fluid/data_feeder.py). Dense slots stack to one array;
lod_level-1 slots pack to `(data [total, ...], [offsets])` pairs, the
Executor's ragged feed (core/kernels_sequence.py). Integer slots keep
their declared width (the port's Executor runs int64 ids as int64);
float64 narrows to float32. `AsyncDeviceFeeder` uploads feed dicts to
the card from a background thread, ahead of the training loop."""

from __future__ import annotations

import queue
import threading
import warnings

import numpy as np
import torch

from .core.program import Variable

__all__ = ["DataFeeder", "AsyncDeviceFeeder"]

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

    On the card the producer thread copies each array into fresh pinned
    memory unless it is pinned already (the caching host allocator keeps
    a pinned block until the copy that reads it is done, so no buffer is
    reused in flight) and uploads it with `non_blocking=True` on a side stream, recording an
    event after the copies. The consumer's stream waits on that event
    before a batch is handed out, and each tensor is recorded on the
    consumer's stream, so the executor reads it (with no second copy:
    it is on its device already) only after its upload. A ragged
    `(data, lod)` feed keeps its offsets on the host. `upload=False`
    keeps every array on the host, still overlapping the reading.

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
        self.device = core.place_device(place) if upload else None
        cuda = self.device is not None and self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if cuda else None

        def _upload(v):
            if isinstance(v, tuple) and len(v) == 2 and not np.isscalar(
                    v[0]):
                # (data, lod): the offsets stay on the host
                return (_upload(v[0]), v[1])
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(np.array(v))  # an array of its own
            elif not isinstance(v, torch.Tensor):
                return v
            if not cuda:
                return v.to(self.device)
            if not v.is_pinned():
                v = v.pin_memory()
            return v.to(self.device, non_blocking=True)

        def _producer():
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for feed in feed_iter:
                    if self._stop.is_set():
                        return
                    if cuda:
                        with torch.cuda.stream(self._stream):
                            item = {k: _upload(v) for k, v in feed.items()}
                            ready = torch.cuda.Event()
                            ready.record(self._stream)
                        item = (item, ready)
                    elif upload:
                        item = ({k: _upload(v) for k, v in feed.items()},
                                None)
                    else:
                        item = (dict(feed), None)
                    self._q.put(item)
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
                consumer = torch.cuda.current_stream(self.device)
                consumer.wait_event(ready)
                for v in feed.values():
                    t = v[0] if isinstance(v, tuple) else v
                    if isinstance(t, torch.Tensor) and t.is_cuda:
                        t.record_stream(consumer)
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
