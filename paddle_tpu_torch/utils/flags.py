"""Process flags (reference paddle/utils/Flags.cpp:18-100 defines the
central gflags: use_gpu, trainer_count, port, trainer_id, ...; fluid
re-exposes them through pybind init_gflags). The port's copy of the JAX
package's registry: a flag starts from PADDLE_FLAG_<NAME>, else from
PADDLE_FLAGS="a=1,b=2", else from its default, and may be set on
`FLAGS` at run time. The executor's numerics guard reads
`FLAGS.check_nan_inf`."""

from __future__ import annotations

import os
from typing import Any, Dict

__all__ = ["FLAGS", "DEFINE_bool", "DEFINE_int", "DEFINE_float",
           "DEFINE_string"]


class _Flags(object):
    def __init__(self):
        self._defs: Dict[str, Any] = {}

    def _define(self, name, default, cast):
        env = os.environ.get("PADDLE_FLAG_%s" % name.upper())
        if env is None:
            pairs = os.environ.get("PADDLE_FLAGS", "")
            for kv in pairs.split(","):
                k, _, v = kv.partition("=")
                if k.strip() == name:
                    env = v.strip()
        if env is not None:
            if cast is bool:
                default = env not in ("0", "false", "False", "")
            else:
                default = cast(env)
        self._defs[name] = default

    def __getattr__(self, name):
        try:
            return self.__dict__["_defs"][name]
        except KeyError:
            raise AttributeError("undefined flag %r" % name)

    def __setattr__(self, name, value):
        if name == "_defs":
            object.__setattr__(self, name, value)
        else:
            self._defs[name] = value

    def as_dict(self):
        return dict(self._defs)


FLAGS = _Flags()


def DEFINE_bool(name, default, help=""):
    FLAGS._define(name, bool(default), bool)


def DEFINE_int(name, default, help=""):
    FLAGS._define(name, int(default), int)


def DEFINE_float(name, default, help=""):
    FLAGS._define(name, float(default), float)


def DEFINE_string(name, default, help=""):
    FLAGS._define(name, default, str)


# the central flags the reference defines (Flags.cpp)
DEFINE_bool("use_gpu", True, "accelerator on (the CUDA card here)")
DEFINE_int("trainer_count", 1, "data-parallel width (mesh 'data' axis)")
DEFINE_int("trainer_id", 0, "this process's index")
DEFINE_int("port", 7164, "service port (coordinator)")
DEFINE_int("num_gradient_servers", 1, "kept for parity; collectives now")
DEFINE_bool("check_nan_inf", False, "scan step outputs for NaN/Inf")
DEFINE_int("v", 0, "vlog verbosity")
