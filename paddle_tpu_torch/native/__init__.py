"""Native (C++) record files, prefetch queue and inference runner, loaded
via ctypes (counterpart of paddle_tpu/native/__init__.py).

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

`inference.cc` is the JAX package's dependency-free inference runner,
copied with its C ABI (`ptpu_infer_*`): it loads the bundle that
`fluid.io.save_inference_model` writes (either package's) and runs it
forward on the CPU in f32, with no Python behind it. It builds the same
way, to `libptpu_infer-<digest>.so`; `infer_lib_path()` gives that file
to any language that can dlopen it, and `InferenceRunner` binds it here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

__all__ = ["lib", "available", "RecordWriter", "read_records",
           "PrefetchReader", "infer_lib_path", "infer_lib",
           "InferenceRunner"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "recordio.cc")
_INFER_SRC = os.path.join(_HERE, "inference.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()
_lib = None
_build_error = None
# the runner's build (seconds of g++) must not hold up the record library
_infer_lock = threading.Lock()
_infer_lib = None


def _so_path(src: str = _SRC, name: str = "recordio") -> str:
    """`lib<name>-<digest of the source and the flags>.so` in _build/."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    return os.path.join(_BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def _build(so: str, src: str = _SRC):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = "%s.%d.tmp" % (so, os.getpid())
    subprocess.run(["g++", *_FLAGS, src, "-o", tmp], check=True,
                   capture_output=True)
    os.replace(tmp, so)


def _error_text(e) -> str:
    detail = getattr(e, "stderr", None)
    return "%s%s" % (e, (": " + detail.decode(errors="replace"))
                     if detail else "")


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
            _build_error = _error_text(e)
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


def infer_lib_path() -> str:
    """Build (if need be) and return the path of the inference runner's
    shared library: usable from any language through dlopen, with no
    paddle_tpu_torch import at load or forward time (capi parity,
    reference capi/gradient_machine.h:36,73). Raises RuntimeError when it
    cannot be built; a later call tries again."""
    with _infer_lock:
        try:
            so = _so_path(_INFER_SRC, "ptpu_infer")
            if not os.path.exists(so):
                _build(so, _INFER_SRC)
        except (OSError, subprocess.CalledProcessError) as e:
            raise RuntimeError("cannot build native inference: %s"
                               % _error_text(e))
        return so


def infer_lib():
    """ctypes handle to the inference runner, with its signatures set."""
    global _infer_lib
    path = infer_lib_path()
    with _infer_lock:
        if _infer_lib is not None:
            return _infer_lib
        L = ctypes.CDLL(path)
        vp, cp, i64p = ctypes.c_void_p, ctypes.c_char_p, \
            ctypes.POINTER(ctypes.c_int64)
        for fn, res, args in (
                ("ptpu_infer_create", vp, [cp]),
                ("ptpu_infer_num_feeds", ctypes.c_int, [vp]),
                ("ptpu_infer_feed_name", cp, [vp, ctypes.c_int]),
                ("ptpu_infer_num_fetch", ctypes.c_int, [vp]),
                ("ptpu_infer_fetch_name", cp, [vp, ctypes.c_int]),
                ("ptpu_infer_set_input", ctypes.c_int,
                 [vp, cp, vp, ctypes.c_int, i64p, ctypes.c_int]),
                ("ptpu_infer_set_input_lod", ctypes.c_int,
                 [vp, cp, i64p, ctypes.c_int]),
                ("ptpu_infer_forward", ctypes.c_int, [vp]),
                ("ptpu_infer_error", cp, [vp]),
                ("ptpu_infer_out_rank", ctypes.c_int, [vp, ctypes.c_int]),
                ("ptpu_infer_out_shape", i64p, [vp, ctypes.c_int]),
                ("ptpu_infer_out_data", ctypes.POINTER(ctypes.c_float),
                 [vp, ctypes.c_int]),
                ("ptpu_infer_out_lod_len", ctypes.c_int,
                 [vp, ctypes.c_int]),
                ("ptpu_infer_out_lod", i64p, [vp, ctypes.c_int]),
                ("ptpu_infer_destroy", None, [vp])):
            f = getattr(L, fn)
            f.restype, f.argtypes = res, args
        _infer_lib = L
        return _infer_lib


class InferenceRunner(object):
    """Python wrapper over the runner's C ABI (the C ABI itself is the
    deliverable; this class saves the ctypes boilerplate in-process).
    It runs on the CPU, as the JAX package's does: feeds are numpy
    arrays, integer ones carried as int64 (embedding ids), the rest as
    f32; ragged inputs take their int64 sequence offsets in `lods`."""

    def __init__(self, dirname: str):
        self._L = infer_lib()
        self._h = self._L.ptpu_infer_create(os.fsencode(dirname))
        if not self._h:
            raise IOError("cannot load inference bundle at %s" % dirname)

    @property
    def feed_names(self):
        L, h = self._L, self._h
        return [L.ptpu_infer_feed_name(h, i).decode()
                for i in range(L.ptpu_infer_num_feeds(h))]

    @property
    def fetch_names(self):
        L, h = self._L, self._h
        return [L.ptpu_infer_fetch_name(h, i).decode()
                for i in range(L.ptpu_infer_num_fetch(h))]

    def run(self, feeds: dict, lods: dict = None, return_lod: bool = False):
        """feeds: name -> array. lods: name -> offsets (ragged inputs).
        With return_lod, returns (outs, lods_out) where lods_out[k] is
        the k-th fetch's sequence offsets ([] when dense)."""
        import numpy as np

        L, h = self._L, self._h
        for name, arr in feeds.items():
            arr = np.asarray(arr)
            if arr.dtype.kind in "iu":
                arr, code = np.ascontiguousarray(arr, np.int64), 1
            else:
                arr, code = np.ascontiguousarray(arr, np.float32), 0
            shape = (ctypes.c_int64 * arr.ndim)(*arr.shape)
            L.ptpu_infer_set_input(h, name.encode(),
                                   arr.ctypes.data_as(ctypes.c_void_p),
                                   code, shape, arr.ndim)
        for name, off in (lods or {}).items():
            off = np.ascontiguousarray(off, np.int64)
            rc = L.ptpu_infer_set_input_lod(
                h, name.encode(),
                off.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(off))
            if rc != 0:
                raise KeyError("lod for unknown input %r (set its tensor "
                               "first)" % name)
        if L.ptpu_infer_forward(h) != 0:
            raise RuntimeError("native forward failed: %s"
                               % L.ptpu_infer_error(h).decode())
        outs, lods_out = [], []
        for i in range(L.ptpu_infer_num_fetch(h)):
            rank = L.ptpu_infer_out_rank(h, i)
            shape = [L.ptpu_infer_out_shape(h, i)[k] for k in range(rank)]
            n = int(np.prod(shape)) if shape else 1
            data = np.ctypeslib.as_array(L.ptpu_infer_out_data(h, i),
                                         shape=(n,)).copy()
            outs.append(data.reshape(shape))
            if return_lod:
                ll = L.ptpu_infer_out_lod_len(h, i)
                ptr = L.ptpu_infer_out_lod(h, i) if ll else None
                lods_out.append([ptr[k] for k in range(ll)])
        return (outs, lods_out) if return_lod else outs

    def close(self):
        if self._h:
            self._L.ptpu_infer_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


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
