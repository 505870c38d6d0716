"""Attribute classes as a module (reference trainer_config_helpers/attrs.py)."""

from . import (  # noqa: F401
    ExtraAttr,
    ExtraLayerAttribute,
    HookAttr,
    ParamAttr,
    ParameterAttribute,
)

__all__ = [
    "HookAttr", "ParamAttr", "ExtraAttr",
    "ParameterAttribute", "ExtraLayerAttribute",
]
