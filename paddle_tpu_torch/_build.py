"""Build and load the port's CUDA kernels (csrc/*.cu) with nvcc at
first use.

Each source compiles on its own into a shared library with a plain C
interface under `paddle_tpu_torch/_build/` (listed in .gitignore), named
by a digest of the source and the flags so an edited source never
loads a stale library. Several sources build in parallel: one nvcc
process per source, all started together, each waited for. nvcc's
report (-Xptxas -v) is kept beside each library as `<library>.log`. The
libraries are loaded with ctypes; callers declare argtypes/restype.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable

__all__ = ["NVCC_FLAGS", "build", "compiler_output", "load"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# sm_90a (not sm_90): wgmma and setmaxnreg exist only for that target;
# -Xptxas -v reports registers, shared memory and spills per kernel
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels build on a machine with the CUDA "
            "toolkit")
    return found


def _lib_path(name: str) -> str:
    src = os.path.join(CSRC, name + ".cu")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (name, digest.hexdigest()[:12]))


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named csrc/<name>.cu whose library is missing, all
    nvcc processes in parallel; returns {name: library path}. Raises
    with the compiler's output when any build fails."""
    names = list(names)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.exists(paths[n])]
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    try:
        for n in todo:
            tmp = "%s.%d.tmp" % (paths[n], os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, n + ".cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT),
                        tmp)
        failed = []
        for n, (p, tmp) in procs.items():
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                failed.append("%s (exit %d):\n%s" % (n, p.returncode, log))
                continue
            with open(paths[n] + ".log", "w") as f:
                f.write(log)
            os.replace(tmp, paths[n])  # atomic: no half-written library
    finally:
        for p, _tmp in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def compiler_output(name: str) -> str:
    """nvcc's output (-Xptxas -v: registers, stack, spills per kernel)
    for csrc/<name>.cu's current library, kept beside it at build."""
    with open(build([name])[name] + ".log") as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and load it."""
    return ctypes.CDLL(build([name])[name])
