"""Auto-generated thin layer wrappers for element-wise / activation ops
(reference layers/ops.py + layer_function_generator.py)."""

from __future__ import annotations

from ..layer_helper import LayerHelper

__activations__ = [
    "sigmoid",
    "logsigmoid",
    "exp",
    "relu",
    "tanh",
    "tanh_shrink",
    "softshrink",
    "sqrt",
    "abs",
    "ceil",
    "floor",
    "round",
    "reciprocal",
    "log",
    "square",
    "softplus",
    "softsign",
    "brelu",
    "leaky_relu",
    "soft_relu",
    "elu",
    "relu6",
    "pow",
    "stanh",
    "hard_shrink",
    "thresholded_relu",
    "hard_sigmoid",
    "swish",
    "softmax",
]

__all__ = __activations__ + [
    "mean",
    "mul",
    "scale",
    "clip",
    "clip_by_norm",
    "elementwise_add",
    "elementwise_sub",
    "elementwise_mul",
    "elementwise_div",
    "elementwise_max",
    "elementwise_min",
    "elementwise_pow",
    "sequence_softmax",
]


def _single_in(op_type, out_dtype=None):
    def layer(x=None, **kwargs):
        if x is None:
            x = kwargs.pop("x", None) or kwargs.pop("input")
        attrs = {
            k: v
            for k, v in kwargs.items()
            if k not in ("name", "main_program", "startup_program") and v is not None
        }
        helper = LayerHelper(op_type, name=kwargs.get("name"))
        out = helper.create_tmp_variable(dtype=out_dtype or x.dtype)
        helper.append_op(
            type=op_type, inputs={"X": [x]}, outputs={"Out": [out]}, attrs=attrs
        )
        return out

    layer.__name__ = op_type
    layer.__doc__ = "The %s op (see core/kernels_*.py)." % op_type
    return layer


for _op in __activations__ + ["clip", "clip_by_norm", "sequence_softmax"]:
    globals()[_op] = _single_in(_op)


def mean(x=None, **kwargs):
    if x is None:
        x = kwargs.pop("x")
    helper = LayerHelper("mean", name=kwargs.get("name"))
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def scale(x=None, scale=1.0, bias=0.0, **kwargs):
    if x is None:
        x = kwargs.pop("x", None) or kwargs.pop("input")
    helper = LayerHelper("scale", name=kwargs.get("name"))
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="scale",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"scale": float(scale), "bias": float(bias)},
    )
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, **kwargs):
    helper = LayerHelper("mul", name=kwargs.get("name"))
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="mul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"x_num_col_dims": x_num_col_dims, "y_num_col_dims": y_num_col_dims},
    )
    return out


def _elementwise(op_type):
    def layer(x, y, axis=-1, act=None, name=None):
        helper = LayerHelper(op_type, name=name, act=act)
        out = helper.create_tmp_variable(dtype=x.dtype)
        helper.append_op(
            type=op_type,
            inputs={"X": [x], "Y": [y]},
            outputs={"Out": [out]},
            attrs={"axis": axis},
        )
        return helper.append_activation(out)

    layer.__name__ = op_type
    return layer


elementwise_add = _elementwise("elementwise_add")
elementwise_sub = _elementwise("elementwise_sub")
elementwise_mul = _elementwise("elementwise_mul")
elementwise_div = _elementwise("elementwise_div")
elementwise_max = _elementwise("elementwise_max")
elementwise_min = _elementwise("elementwise_min")
elementwise_pow = _elementwise("elementwise_pow")
