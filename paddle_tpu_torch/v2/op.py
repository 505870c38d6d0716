"""Math operations over v2 layers (reference python/paddle/v2/op.py).

Registers unary math functions (paddle.v2.op.exp(layer) etc., each a
mixed layer with the activation applied) and patches +, -, *, neg onto
the Layer node so `a + b`, `2.0 * a` build graphs — same surface as the
reference, lowered through the one fluid core.
"""

from __future__ import annotations

import numbers

from .. import trainer_config_helpers as conf
from . import activation as act
from .config_base import Layer

__all__ = []


def __register_unary_math_op__(op_name, activation):
    def op(input, name=None):
        return conf.mixed_layer(
            input=[conf.identity_projection(input=input)],
            name=name,
            act=activation,
        )

    op.__name__ = op_name
    op.__doc__ = type(activation).__doc__
    globals()[op_name] = op
    __all__.append(op_name)


__register_unary_math_op__("exp", act.Exp())
__register_unary_math_op__("log", act.Log())
__register_unary_math_op__("abs", act.Abs())
__register_unary_math_op__("sigmoid", act.Sigmoid())
__register_unary_math_op__("tanh", act.Tanh())
__register_unary_math_op__("square", act.Square())
__register_unary_math_op__("relu", act.Relu())
__register_unary_math_op__("sqrt", act.SquareRootN())
__register_unary_math_op__("reciprocal", act.Reciprocal())
__register_unary_math_op__("softmax", act.Softmax())


def _size_of(node):
    return node.attrs.get("size") if hasattr(node, "attrs") else None


def __add__(layeroutput, other):
    if isinstance(other, numbers.Number):
        return conf.slope_intercept_layer(
            input=layeroutput, intercept=float(other)
        )
    if not isinstance(other, Layer):
        raise TypeError(
            "Layer can only be added with another Layer or a number"
        )
    return conf.mixed_layer(input=[
        conf.identity_projection(input=layeroutput),
        conf.identity_projection(input=other),
    ])


Layer.__radd__ = __add__
Layer.__add__ = __add__


def __neg__(layeroutput):
    return conf.slope_intercept_layer(input=layeroutput, slope=-1.0)


Layer.__neg__ = __neg__


def __sub__(layeroutput, other):
    if isinstance(other, numbers.Number):
        return conf.slope_intercept_layer(
            input=layeroutput, intercept=-float(other)
        )
    if not isinstance(other, Layer):
        raise TypeError(
            "Layer can only be subtracted with another Layer or a number"
        )
    return __add__(layeroutput, __neg__(other))


Layer.__sub__ = __sub__


def __rsub__(layeroutput, other):
    return __add__(__neg__(layeroutput), other)


Layer.__rsub__ = __rsub__


def __mul__(layeroutput, other):
    if isinstance(other, numbers.Number):
        return conf.slope_intercept_layer(
            input=layeroutput, slope=float(other)
        )
    if not isinstance(other, Layer):
        raise TypeError(
            "Layer can only be multiplied with another Layer or a number"
        )
    if _size_of(layeroutput) == 1:
        return conf.scaling_layer(input=other, weight=layeroutput)
    if _size_of(other) == 1:
        return conf.scaling_layer(input=layeroutput, weight=other)
    raise TypeError(
        "At least one of the operands of '*' must be a number or a "
        "Layer with size=1"
    )


Layer.__mul__ = __mul__
Layer.__rmul__ = __mul__
