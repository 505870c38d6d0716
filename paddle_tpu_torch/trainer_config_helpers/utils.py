"""trainer_config_helpers/utils.py (reference): the deprecated()
decorator configs import."""

from __future__ import annotations

import functools
import warnings

__all__ = ["deprecated"]


def deprecated(instead):
    def deco(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            warnings.warn(
                "%s is deprecated, use %s instead"
                % (func.__name__, instead),
                DeprecationWarning, stacklevel=2,
            )
            return func(*args, **kwargs)

        return wrapper

    return deco
