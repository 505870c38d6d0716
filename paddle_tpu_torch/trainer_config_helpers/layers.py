"""Layer wrappers as a module (reference
trainer_config_helpers/layers.py, 7.5k LoC of wrapper defs). All
wrappers live in the package __init__; this module mirrors the
reference's module path so `from paddle.trainer_config_helpers.layers
import fc_layer` style imports work unchanged."""

from . import __all__ as _pkg_all
from . import *  # noqa: F401,F403

__all__ = list(_pkg_all)
