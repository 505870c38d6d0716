"""Process flags: the one the port reads, `check_nan_inf` (reference
paddle/utils/Flags.cpp; the JAX package keeps the whole gflags
registry in paddle_tpu/utils/flags.py). It starts from the environment
variable PADDLE_FLAG_CHECK_NAN_INF, as the JAX package's flag does, and
may be set on `FLAGS` at run time."""

from __future__ import annotations

import os


class _Flags(object):
    def __init__(self):
        env = os.environ.get("PADDLE_FLAG_CHECK_NAN_INF")
        self.check_nan_inf = (env is not None
                              and env not in ("0", "false", "False", ""))


FLAGS = _Flags()
