"""Default-filling decorators as a module (reference
trainer_config_helpers/default_decorators.py)."""

from . import (  # noqa: F401
    wrap_act_default,
    wrap_bias_attr_default,
    wrap_name_default,
    wrap_param_attr_default,
    wrap_param_default,
)

__all__ = [
    "wrap_name_default", "wrap_param_attr_default",
    "wrap_bias_attr_default", "wrap_act_default", "wrap_param_default",
]
