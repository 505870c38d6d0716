"""Tensor creation/manipulation layers (reference layers/tensor.py)."""

from __future__ import annotations

from ..core.program import Variable
from ..initializer import Constant
from ..layer_helper import LayerHelper

__all__ = [
    "create_tensor",
    "create_parameter",
    "create_global_var",
    "cast",
    "concat",
    "sums",
    "assign",
    "fill_constant",
    "fill_constant_batch_size_like",
    "ones",
    "zeros",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(
        name=helper.name, dtype=dtype, persistable=persistable
    )


def create_parameter(
    shape, dtype, name=None, attr=None, is_bias=False, default_initializer=None
):
    from ..param_attr import ParamAttr

    helper = LayerHelper("create_parameter", name=name)
    attr = ParamAttr.to_attr(attr)
    if attr.name is None and name is not None:
        attr.name = name
    return helper.create_parameter(attr, shape, dtype, is_bias, default_initializer)


def create_global_var(shape, value, dtype, persistable=False, force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable, name=name
    )
    helper.set_variable_initializer(var, initializer=Constant(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(
        type="cast",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"in_dtype": x.dtype, "out_dtype": dtype},
    )
    return out


def concat(input, axis=0):
    helper = LayerHelper("concat", **locals())
    out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(
        type="concat",
        inputs={"X": input},
        outputs={"Out": [out]},
        attrs={"axis": axis},
    )
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input}, outputs={"Out": [out]})
    return out


def assign(input, output):
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        helper.append_op(
            type="assign", inputs={"X": [input]}, outputs={"Out": [output]}
        )
    else:
        import numpy as np

        arr = np.asarray(input)
        helper.append_op(
            type="assign_value",
            outputs={"Out": [output]},
            attrs={
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "values": arr.reshape(-1).tolist(),
            },
        )
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(
        type="fill_constant",
        outputs={"Out": [out]},
        attrs={"shape": list(shape), "dtype": dtype, "value": float(value)},
    )
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(
    input, shape, dtype, value, input_dim_idx=0, output_dim_idx=0
):
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(
        type="fill_constant_batch_size_like",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={
            "shape": list(shape),
            "dtype": dtype,
            "value": float(value),
            "input_dim_idx": input_dim_idx,
            "output_dim_idx": output_dim_idx,
        },
    )
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)
