"""Flags, logging and scoped timers (reference paddle/utils: Flags.cpp
gflags registry, Logging.h glog shim, Stat.h REGISTER_TIMER RAII timers
aggregated in a global StatSet, printed per pass), beside the threefry
PRNG, the O(1) running-stat accumulator and the EWMA/hysteresis trip
detector; the image, config and conversion tools are modules of their
own here (`image_util`, `preprocess_img`, `dump_config`, ...)."""

from .flags import DEFINE_bool, DEFINE_float, DEFINE_int, DEFINE_string, FLAGS
from .logging import get_logger, vlog
from .stat import StatSet, global_stats, timer

__all__ = [
    "FLAGS", "DEFINE_bool", "DEFINE_int", "DEFINE_float", "DEFINE_string",
    "get_logger", "vlog", "timer", "StatSet", "global_stats",
]
