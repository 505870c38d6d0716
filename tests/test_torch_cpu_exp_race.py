"""The first CPU `torch.exp` of a process, when it is wide enough to split
over OpenMP threads, can come back up to ~1e-4 off in one thread's share
(the exp's lazy first-call set-up run by two threads at once); later
exps are right. The port's plain attention versions compute their
softmax with `kernel_utils.guarded_exp`, and `kernel_utils` runs one
1-element exp when imported, so their first exp never races.

The test runs fresh processes that import `kernel_utils` and then do a
wide first exp on 2 threads; each must match float64 within 1e-6.

    python tests/test_torch_cpu_exp_race.py N

runs N fresh processes without the import ("cold") and N with it
("warm"), 16 at a time, and prints how many drifted in each."""

import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = """
import sys
import numpy as np
import torch
torch.set_num_threads(2)
if sys.argv[1] == "warm":
    import paddle_tpu_torch.parallel.kernel_utils  # noqa: F401
x = torch.from_numpy(
    -np.random.RandomState(0).rand(2, 4, 128, 128).astype(np.float32) * 20)
err = np.abs(torch.exp(x).numpy() - np.exp(x.numpy().astype(np.float64)))
print(float(err.max()))
"""


def _first_exp_errors(mode, n, parallel=16):
    env = dict(os.environ, PYTHONPATH=ROOT)
    errs = []
    for start in range(0, n, parallel):
        procs = [subprocess.Popen([sys.executable, "-c", _CHILD, mode],
                                  cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                  text=True)
                 for _ in range(min(parallel, n - start))]
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0
            errs.append(float(out.strip().splitlines()[-1]))
    return np.array(errs)


def test_first_exp_after_importing_kernel_utils_is_exact():
    errs = _first_exp_errors("warm", 4, parallel=4)
    assert (errs < 1e-6).all(), errs


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 160
    for mode in ("cold", "warm"):
        errs = _first_exp_errors(mode, n)
        print("%s: %d of %d processes drifted (max error %.3e)"
              % (mode, int((errs >= 1e-6).sum()), n, float(errs.max())))
