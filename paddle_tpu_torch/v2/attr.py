"""paddle.v2.attr (reference python/paddle/v2/attr.py): parameter /
extra-layer attribute classes, shared with the config DSL."""

from ..trainer_config_helpers import (  # noqa: F401
    ExtraAttr,
    ExtraLayerAttribute,
    HookAttr,
    HookAttribute,
    ParamAttr,
    ParameterAttribute,
)

Param = ParamAttr
Extra = ExtraAttr
Hook = HookAttr

__all__ = ["Param", "Extra", "Hook", "ParamAttr", "ExtraAttr",
           "ParameterAttribute", "ExtraLayerAttribute", "HookAttr",
           "HookAttribute"]
