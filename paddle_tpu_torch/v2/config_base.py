"""v2 config base (reference python/paddle/v2/config_base.py).

The reference aliases `Layer` to trainer_config_helpers' LayerOutput and
wraps every DSL function so created layers register in `__layer_map__`
for topology traversal. Here the v2 DSL node (v2/layer.py Layer) IS the
LayerOutput — one node class under both surfaces — and nodes
self-register at construction (Layer._registry), so the conversion
wrapper only needs to preserve name/doc metadata.
"""

from __future__ import annotations

from .layer import Layer

__layer_map__ = {}


def __convert_to_v2__(f, name, module):
    def wrapped(*args, **kwargs):
        out = f(*args, **kwargs)
        outs = out if isinstance(out, (list, tuple)) else [out]
        for l in outs:
            if isinstance(l, Layer):
                __layer_map__[l.name] = l
        return out

    wrapped.__doc__ = f.__doc__
    wrapped.__name__ = name
    wrapped.__module__ = module
    return wrapped


__all__ = ["Layer", "__layer_map__", "__convert_to_v2__"]
