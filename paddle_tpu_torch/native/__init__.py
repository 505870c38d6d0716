"""Native (C++) record files and prefetch queue, loaded via ctypes
(counterpart of the recordio part of paddle_tpu/native/__init__.py).

`recordio.cc` is the JAX package's source, copied: one record is
`[u32 magic][u32 len][u32 crc32(payload)][payload]`, so a record file
written by either package reads in the other. It is host C++, compiled
at first use with g++ (`-O2 -std=c++17 -shared -fPIC -pthread`) into
`paddle_tpu_torch/_build/` (listed in .gitignore) under a name that
carries a digest of the source and the flags, so an edited source never
loads a stale library; the compiler writes a file of its own and an
atomic rename publishes it, so processes that build at once never load
half a library. Nothing builds at import. Without g++ every entry point
raises: there is no Python reader in its place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["lib", "available", "RecordWriter", "read_records",
           "PrefetchReader"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "recordio.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_build_error = None


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, "librecordio-%s.so"
                        % digest.hexdigest()[:12])


def _build(so: str):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def lib():
    """The loaded shared library, building it on first use. Raises
    RuntimeError when it cannot be built or loaded."""
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError("native build failed earlier: %s"
                               % _build_error)
        try:
            so = _so_path()
            if not os.path.exists(so):
                _build(so)
            L = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", None)
            _build_error = "%s%s" % (e, (": " + detail.decode(
                errors="replace")) if detail else "")
            raise RuntimeError("cannot build/load native recordio: %s"
                               % _build_error)
        L.rio_writer_open.restype = ctypes.c_void_p
        L.rio_writer_open.argtypes = [ctypes.c_char_p]
        L.rio_write.restype = ctypes.c_int
        L.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_uint32]
        L.rio_writer_close.restype = None
        L.rio_writer_close.argtypes = [ctypes.c_void_p]
        L.rio_open.restype = ctypes.c_void_p
        L.rio_open.argtypes = [ctypes.c_char_p]
        L.rio_next.restype = ctypes.c_int64
        L.rio_next.argtypes = [ctypes.c_void_p]
        L.rio_data.restype = ctypes.POINTER(ctypes.c_uint8)
        L.rio_data.argtypes = [ctypes.c_void_p]
        L.rio_close.restype = None
        L.rio_close.argtypes = [ctypes.c_void_p]
        L.pq_open.restype = ctypes.c_void_p
        L.pq_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ]
        L.pq_next.restype = ctypes.c_int64
        L.pq_next.argtypes = [ctypes.c_void_p]
        L.pq_data.restype = ctypes.POINTER(ctypes.c_uint8)
        L.pq_data.argtypes = [ctypes.c_void_p]
        L.pq_close.restype = None
        L.pq_close.argtypes = [ctypes.c_void_p]
        _lib = L
        return _lib


def available() -> bool:
    try:
        lib()
        return True
    except RuntimeError:
        return False


class RecordWriter(object):
    """Length-prefixed CRC-checked record file writer (the JAX package's
    bespoke format, recordio.cc: not the reference's chunked RecordIO
    layout)."""

    def __init__(self, path: str):
        self._h = lib().rio_writer_open(path.encode())
        if not self._h:
            raise IOError("cannot open %s for writing" % path)

    def write(self, payload: bytes):
        payload = bytes(payload)
        if lib().rio_write(self._h, payload, len(payload)) != 0:
            raise IOError("record write failed")

    def close(self):
        if self._h:
            lib().rio_writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_records(path: str):
    """Synchronous record iterator. A torn tail or a record that fails
    its CRC ends the stream before it; an empty record is a record."""
    L = lib()
    h = L.rio_open(path.encode())
    if not h:
        raise IOError("cannot open %s" % path)
    try:
        while True:
            n = L.rio_next(h)
            if n < 0:
                return
            yield ctypes.string_at(L.rio_data(h), n) if n else b""
    finally:
        L.rio_close(h)


class PrefetchReader(object):
    """Async prefetch over a list of record files: a native thread streams
    records into a bounded queue (PyDataProvider2 double-buffer parity);
    iteration pops from the queue."""

    def __init__(self, paths, capacity: int = 64):
        L = lib()
        self._names = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._names))(*self._names)
        self._h = L.pq_open(arr, len(self._names), int(capacity))
        self._L = L

    def __iter__(self):
        return self

    def __next__(self):
        if not self._h:
            raise StopIteration
        n = self._L.pq_next(self._h)
        if n < 0:
            self.close()
            raise StopIteration
        return ctypes.string_at(self._L.pq_data(self._h), n) if n else b""

    def close(self):
        if self._h:
            self._L.pq_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
