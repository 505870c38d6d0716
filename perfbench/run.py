"""Run one cell of the benchmark on this machine's card and print its
result as the last line of standard output.

    python3 perfbench/run.py --workload gpt2m.train --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout. Set-up (`setup_s`) is timed from this
file's first statement. Kernel caches stay inside the checkout, at fixed
paths: the port builds its CUDA libraries under paddle_tpu_torch/_build/,
and Triton and torch extensions are pointed at perfbench/.cache/."""

import time

T0 = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    cache = os.path.join(ROOT, "perfbench", ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from perfbench.lib import harness

    return harness.main(argv, t0=T0)


if __name__ == "__main__":
    sys.exit(main())
