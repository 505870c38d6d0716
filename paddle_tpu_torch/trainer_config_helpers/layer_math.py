"""Math operator sugar on DSL layer nodes (reference
trainer_config_helpers/layer_math.py): `a + b`, `a - 2.0`, `0.5 * a`,
and unary `layer_math.exp(a)` etc. build the same graph nodes the
explicit wrappers would."""

from __future__ import annotations

import paddle_tpu_torch.trainer_config_helpers as tch
from ..v2.layer import Layer

__all__ = []


def _width(node):
    """Feature width of a DSL node: image-shaped nodes report c*h*w,
    others defer to Topology's width inference (v2/topology.py
    _node_width semantics without a Topology instance)."""
    shape = getattr(node, "im_shape", None)
    if shape:
        c, h, w = shape
        return int(c) * int(h) * int(w)
    a = getattr(node, "attrs", {})
    if a.get("size"):
        return int(a["size"])
    t = a.get("type")
    if t is not None:
        return int(t.dim)
    if getattr(node, "parents", None):
        return _width(node.parents[0])
    raise ValueError(
        "cannot infer the feature width of layer %r (%s) for layer_math"
        % (getattr(node, "name", node), getattr(node, "kind", "?"))
    )


def register_unary_math_op(op_name, act):
    def op(input, name=None):
        with tch.mixed_layer(
            size=_width(input), act=act, name=name
        ) as m:
            m += tch.identity_projection(input=input)
        return m

    op.__name__ = op_name
    op.__doc__ = "Elementwise %s over a layer (reference layer_math)." \
        % op_name
    globals()[op_name] = op
    __all__.append(op_name)


register_unary_math_op("exp", tch.ExpActivation())
register_unary_math_op("log", tch.LogActivation())
register_unary_math_op("abs", tch.AbsActivation())
register_unary_math_op("sigmoid", tch.SigmoidActivation())
register_unary_math_op("tanh", tch.TanhActivation())
register_unary_math_op("square", tch.SquareActivation())
register_unary_math_op("relu", tch.ReluActivation())
register_unary_math_op("sqrt", tch.SqrtActivation())
register_unary_math_op("reciprocal", tch.ReciprocalActivation())


def _is_number(x):
    return isinstance(x, (int, float)) and not isinstance(x, bool)


def add(layeroutput, other):
    if _is_number(other):
        return tch.slope_intercept_layer(input=layeroutput,
                                         intercept=float(other))
    if not isinstance(other, Layer):
        raise TypeError("a layer can only be added to a layer or number")
    wa, wb = _width(layeroutput), _width(other)
    if wa != wb:
        if wb == 1:
            other = tch.repeat_layer(input=other, num_repeats=wa)
        elif wa == 1:
            layeroutput = tch.repeat_layer(input=layeroutput,
                                           num_repeats=wb)
            wa = wb
        else:
            raise ValueError(
                "layers added with '+' need equal widths (or width 1): "
                "%s vs %s" % (wa, wb)
            )
    with tch.mixed_layer(size=wa or 0) as m:
        m += tch.identity_projection(input=layeroutput)
        m += tch.identity_projection(input=other)
    return m


def sub(layeroutput, other):
    if _is_number(other):
        return tch.slope_intercept_layer(input=layeroutput,
                                         intercept=-float(other))
    if not isinstance(other, Layer):
        raise TypeError(
            "a layer can only be subtracted by a layer or number"
        )
    return add(layeroutput,
               tch.slope_intercept_layer(input=other, slope=-1.0))


def rsub(layeroutput, other):
    if not (_is_number(other) or isinstance(other, Layer)):
        raise TypeError(
            "a layer can only be subtracted from a layer or number"
        )
    return add(tch.slope_intercept_layer(input=layeroutput, slope=-1.0),
               other)


def mul(layeroutput, other):
    if _is_number(other):
        return tch.slope_intercept_layer(input=layeroutput,
                                         slope=float(other))
    if not isinstance(other, Layer):
        raise TypeError("a layer can only be multiplied by a layer or "
                        "number")
    if _width(layeroutput) == 1:
        return tch.scaling_layer(input=other, weight=layeroutput)
    if _width(other) == 1:
        return tch.scaling_layer(input=layeroutput, weight=other)
    raise ValueError(
        "'*' needs a number or a width-1 layer on one side"
    )


Layer.__add__ = add
Layer.__radd__ = add
Layer.__sub__ = sub
Layer.__rsub__ = rsub
Layer.__mul__ = mul
Layer.__rmul__ = mul
