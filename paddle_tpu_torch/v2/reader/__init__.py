"""Composable reader decorators (reference python/paddle/v2/reader/
decorator.py: shuffle:51, compose:118, chain:86, buffered:165,
map_readers:29, firstn:208, xmap_readers:236).

A *reader* is a zero-arg callable returning an iterable of data instances;
a *reader creator* returns readers. Pure host-side Python — the device
never sees this layer."""

from __future__ import annotations

import itertools
import queue as _queue
import random
import threading

from . import creator  # noqa: F401

__all__ = [
    "creator",
    "map_readers",
    "buffered",
    "compose",
    "chain",
    "shuffle",
    "firstn",
    "xmap_readers",
    "ComposeNotAligned",
]


class ComposeNotAligned(ValueError):
    pass


def map_readers(func, *readers):
    """Reader whose items are func(items-of-each-reader...)."""

    def reader():
        rs = [r() for r in readers]
        for e in map(func, *rs):
            yield e

    return reader


def shuffle(reader, buf_size):
    """Buffered shuffle: read buf_size items, shuffle, yield."""

    def data_reader():
        buf = []
        for e in reader():
            buf.append(e)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return data_reader


def chain(*readers):
    """Concatenate readers: all of r1, then all of r2, ..."""

    def reader():
        rs = [r() for r in readers]
        for e in itertools.chain(*rs):
            yield e

    return reader


def compose(*readers, **kwargs):
    """Zip readers item-wise into flattened tuples."""
    check_alignment = kwargs.pop("check_alignment", True)

    def make_tuple(x):
        if isinstance(x, tuple):
            return x
        return (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum(list(map(make_tuple, outputs)), ())
        else:
            for outputs in itertools.zip_longest(*rs):
                if any(o is None for o in outputs):
                    raise ComposeNotAligned(
                        "outputs of readers are not aligned"
                    )
                yield sum(list(map(make_tuple, outputs)), ())

    return reader


def buffered(reader, size):
    """Async prefetch into a bounded queue on a worker thread (the
    PyDataProvider2-style double buffer, reference decorator.py:165)."""

    class _End(object):
        pass

    def data_reader():
        r = reader()
        q = _queue.Queue(maxsize=size)

        def read_worker():
            for d in r:
                q.put(d)
            q.put(_End())

        t = threading.Thread(target=read_worker)
        t.daemon = True
        t.start()
        e = q.get()
        while not isinstance(e, _End):
            yield e
            e = q.get()

    return data_reader


def firstn(reader, n):
    def firstn_reader():
        for i, item in enumerate(reader()):
            if i == n:
                break
            yield item

    return firstn_reader


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Parallel map over a reader with worker threads (reference uses
    threads too, decorator.py:236)."""
    end = object()
    end_count = [0]

    def read_worker(r, in_q):
        for i, d in enumerate(r):
            in_q.put((i, d) if order else d)
        in_q.put(end)

    def handle_worker(in_q, out_q):
        sample = in_q.get()
        while sample is not end:
            if order:
                i, d = sample
                out_q.put((i, mapper(d)))
            else:
                out_q.put(mapper(sample))
            sample = in_q.get()
        in_q.put(end)
        out_q.put(end)

    def xreader():
        in_q = _queue.Queue(buffer_size)
        out_q = _queue.Queue(buffer_size)
        t = threading.Thread(target=read_worker, args=(reader(), in_q))
        t.daemon = True
        t.start()
        workers = []
        for _ in range(process_num):
            w = threading.Thread(target=handle_worker, args=(in_q, out_q))
            w.daemon = True
            w.start()
            workers.append(w)

        finished = 0
        if order:
            buf = {}
            next_i = 0
            while finished < process_num:
                sample = out_q.get()
                if sample is end:
                    finished += 1
                    continue
                i, d = sample
                buf[i] = d
                while next_i in buf:
                    yield buf.pop(next_i)
                    next_i += 1
        else:
            while finished < process_num:
                sample = out_q.get()
                if sample is end:
                    finished += 1
                    continue
                yield sample

    return xreader


class PipeReader(object):
    """Stream records from a shell command's stdout (reference
    reader/decorator.py PipeReader): `get_line` yields lines (or
    fixed-size chunks when line splitting is off) — the HDFS/S3/curl
    ingestion hook."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        if not isinstance(command, str):
            raise TypeError("PipeReader needs a command string")
        self.command = command
        self.bufsize = int(bufsize)
        if file_type not in ("plain", "gzip"):
            raise TypeError("file_type must be 'plain' or 'gzip'")
        self.file_type = file_type

    def get_line(self, cut_lines=True, line_break="\n"):
        import subprocess
        import zlib

        proc = subprocess.Popen(
            self.command, shell=True, bufsize=self.bufsize,
            stdout=subprocess.PIPE,
        )
        dec = zlib.decompressobj(32 + zlib.MAX_WBITS) \
            if self.file_type == "gzip" else None
        remained = b""
        try:
            while True:
                buff = proc.stdout.read(self.bufsize)
                if not buff:
                    break
                if dec is not None:
                    buff = dec.decompress(buff)
                if not cut_lines:
                    if buff:
                        yield buff
                    continue
                remained += buff
                parts = remained.split(line_break.encode())
                remained = parts.pop()
                for line in parts:
                    yield line.decode(errors="replace")
            if cut_lines and remained:
                yield remained.decode(errors="replace")
        finally:
            proc.stdout.close()
            rc = proc.wait()
        if rc != 0:
            raise RuntimeError(
                "PipeReader command %r exited with status %d"
                % (self.command, rc)
            )


__all__.append("PipeReader")
