"""Operator sugar on Variable (reference layers/math_op_patch.py)."""

from __future__ import annotations

import numpy as np

from ..core.program import Variable, unique_name


def _scalar_to_var(block, value, dtype):
    var = block.create_var(
        name=unique_name("_scalar_const"), shape=(1,), dtype=dtype
    )
    block.append_op(
        type="fill_constant",
        outputs={"Out": [var]},
        attrs={"shape": (1,), "dtype": dtype, "value": float(value)},
    )
    return var


def binary(x: Variable, other, op_type: str, reverse: bool = False) -> Variable:
    block = x.block
    if isinstance(other, Variable):
        y = other
    elif np.isscalar(other):
        y = _scalar_to_var(block, other, x.dtype)
    else:
        raise TypeError("cannot combine Variable with %r" % (other,))
    lhs, rhs = (y, x) if reverse else (x, y)
    out_dtype = "bool" if op_type in (
        "less_than", "less_equal", "greater_than", "greater_equal", "equal", "not_equal"
    ) else x.dtype
    out = block.create_var(name=unique_name("_binary_out"), dtype=out_dtype)
    block.append_op(
        type=op_type,
        inputs={"X": [lhs], "Y": [rhs]},
        outputs={"Out": [out]},
        attrs={"axis": -1},
    )
    return out
