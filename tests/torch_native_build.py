"""Build the JAX package's native record library once per machine,
safely under parallel test workers, before a port test loads it.

paddle_tpu/native builds `_build/librecordio.so` at its first use to
one fixed temporary name, guarded by a thread lock only, so test
processes that start together on a fresh checkout can compile over each
other's temporary file (ROADMAP Queue C). `ensure_jax_native()` builds
the same library from the same source with the same g++ flags under a
file lock, to a temporary name of its own, and moves it into place
atomically, only when it is absent or older than its source; the JAX
package then finds it up to date and loads it without building. Call it
before the first use of `paddle_tpu.native` in a test.
"""

import fcntl
import os
import subprocess
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE = os.path.join(_ROOT, "paddle_tpu", "native")
SRC = os.path.join(_NATIVE, "recordio.cc")
SO = os.path.join(_NATIVE, "_build", "librecordio.so")
# paddle_tpu/native/__init__.py `_compile`'s command
FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]


def _fresh():
    return os.path.exists(SO) and \
        os.path.getmtime(SO) >= os.path.getmtime(SRC)


def ensure_jax_native() -> str:
    """The path of the up-to-date library, built here if need be."""
    if _fresh():
        return SO
    os.makedirs(os.path.dirname(SO), exist_ok=True)
    with open(SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not _fresh():  # another process may have built it meanwhile
                tmp = "%s.%d.%d.tmp.so" % (SO, os.getpid(),
                                            threading.get_ident())
                subprocess.run(["g++"] + FLAGS + [SRC, "-o", tmp],
                               check=True, capture_output=True)
                os.replace(tmp, SO)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return SO
