"""Build the JAX package's native libraries (the record library and the
inference runner) once per machine, safely under parallel test workers,
before a port test loads them, and the port's runner under the same
kind of file lock.

paddle_tpu/native builds `_build/librecordio.so` at its first use to
one fixed temporary name, guarded by a thread lock only, so test
processes that start together on a fresh checkout can compile over each
other's temporary file (ROADMAP Queue C). `ensure_jax_native()` builds
the same library from the same source with the same g++ flags under a
file lock, to a temporary name of its own, and moves it into place
atomically, only when it is absent or older than its source; the JAX
package then finds it up to date and loads it without building. Call it
before the first use of `paddle_tpu.native` in a test; `ensure_jax_infer()`
does the same for `_build/libptpu_infer.so` (inference.cc), before the
first `paddle_tpu.native.infer_lib()`. `ensure_port_infer()` builds the
port's runner through `paddle_tpu_torch.native.infer_lib_path()` with
the file lock held, so parallel workers compile it once.
"""

import fcntl
import os
import subprocess
import sys
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_ROOT, "paddle_tpu", "native")
SRC = os.path.join(_NATIVE, "recordio.cc")
SO = os.path.join(_NATIVE, "_build", "librecordio.so")
INFER_SRC = os.path.join(_NATIVE, "inference.cc")
INFER_SO = os.path.join(_NATIVE, "_build", "libptpu_infer.so")
# paddle_tpu/native/__init__.py `_compile`'s command
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _fresh(src, so):
    return os.path.exists(so) and \
        os.path.getmtime(so) >= os.path.getmtime(src)


def _locked(path):
    """An exclusive file lock beside `path`, held while the returned
    file stays open."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lock = open(path + ".lock", "w")
    fcntl.flock(lock, fcntl.LOCK_EX)
    return lock


def _ensure(src, so):
    if _fresh(src, so):
        return so
    with _locked(so):
        if not _fresh(src, so):  # another process may have built it
            tmp = "%s.%d.%d.tmp.so" % (so, os.getpid(),
                                        threading.get_ident())
            subprocess.run(["g++"] + FLAGS + [src, "-o", tmp],
                           check=True, capture_output=True)
            os.replace(tmp, so)
    return so


def _clear_stuck(error, loaded):
    """Drop the build error `error` that the imported paddle_tpu.native
    keeps while its `loaded` handle is still None: the library is in
    place now, so its next load reads the file."""
    mod = sys.modules.get("paddle_tpu.native")
    if mod is None:
        return
    with mod._lock:
        if getattr(mod, loaded) is None and getattr(mod, error) is not None:
            setattr(mod, error, None)


def ensure_jax_native() -> str:
    """The path of the up-to-date record library, built here if need
    be; a stuck build error in paddle_tpu.native is cleared."""
    so = _ensure(SRC, SO)
    _clear_stuck("_build_error", "_lib")
    return so


def ensure_jax_infer() -> str:
    """The path of the JAX package's up-to-date inference runner, built
    here if need be; a stuck build error in paddle_tpu.native is
    cleared."""
    so = _ensure(INFER_SRC, INFER_SO)
    _clear_stuck("_infer_error", "_infer_lib")
    return so


def ensure_port_infer() -> str:
    """The path of the port's inference runner, built (if need be) with
    the file lock held."""
    from paddle_tpu_torch import native

    with _locked(os.path.join(_ROOT, "paddle_tpu_torch", "_build",
                              "libptpu_infer")):
        return native.infer_lib_path()
