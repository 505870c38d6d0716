"""glog-shim logging (reference paddle/utils/Logging.h; VLOG levels are
used as tracing throughout the fluid executor). The port's logger is
named after its package, so a process that loads both packages keeps
one handler on each."""

from __future__ import annotations

import logging
import sys

__all__ = ["get_logger", "vlog"]

_configured = False


def get_logger(name="paddle_tpu_torch", level=logging.INFO):
    global _configured
    logger = logging.getLogger(name)
    if not _configured:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter("%(levelname).1s %(asctime)s %(name)s] %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
        _configured = True
    return logger


def vlog(level, msg, *args):
    """VLOG(level) — gated on the `v` flag."""
    from .flags import FLAGS

    if FLAGS.v >= level:
        get_logger().info(msg, *args)
