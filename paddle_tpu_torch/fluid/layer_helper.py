"""LayerHelper: shared plumbing for layer functions (reference
python/paddle/v2/fluid/layer_helper.py). Creates parameters in the main
program + their init ops in the startup program, temp variables, bias add
and activation tails."""

from __future__ import annotations

import copy
import itertools

from .core.program import (
    Variable,
    default_main_program,
    default_startup_program,
    unique_name,
)
from .initializer import Constant, Xavier
from .param_attr import ParamAttr


class LayerHelper(object):
    def __init__(self, layer_type, **kwargs):
        self.kwargs = kwargs
        self.layer_type = layer_type
        name = self.kwargs.get("name")
        if name is None:
            self.kwargs["name"] = unique_name(self.layer_type)

    @property
    def name(self):
        return self.kwargs["name"]

    @property
    def main_program(self):
        return self.kwargs.get("main_program") or default_main_program()

    @property
    def startup_program(self):
        return self.kwargs.get("startup_program") or default_startup_program()

    def append_op(self, *args, **kwargs):
        return self.main_program.current_block().append_op(*args, **kwargs)

    # --- inputs ---------------------------------------------------------
    def multiple_input(self, input_param_name="input"):
        inputs = self.kwargs.get(input_param_name, [])
        if isinstance(inputs, Variable):
            return [inputs]
        return list(inputs)

    def input(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        if len(inputs) != 1:
            raise ValueError("%s layer needs exactly one input" % self.layer_type)
        return inputs[0]

    @property
    def param_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("param_attr"))

    @property
    def bias_attr(self):
        return ParamAttr.to_attr(self.kwargs.get("bias_attr"))

    def multiple_param_attr(self, length):
        attr = self.param_attr
        if isinstance(attr, ParamAttr):
            attr = [attr]
        if len(attr) != 1 and len(attr) != length:
            raise ValueError("parameter number mismatch")
        if len(attr) == 1 and length != 1:
            extra = []
            for i in range(length - 1):
                a = copy.deepcopy(attr[0])
                # a named attr shared across N inputs would collide: each
                # copy gets a _i suffix (weight per input, reference fc)
                if a.name is not None:
                    a.name = "%s_%d" % (a.name, i)
                extra.append(a)
            attr = [attr[0]] + extra
        return attr

    def iter_inputs_and_params(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        attrs = self.multiple_param_attr(len(inputs))
        return zip(inputs, attrs)

    def input_dtype(self, input_param_name="input"):
        inputs = self.multiple_input(input_param_name)
        dtype = None
        for each in inputs:
            if dtype is None:
                dtype = each.dtype
            elif dtype != each.dtype:
                raise ValueError("all inputs must have the same dtype")
        return dtype

    # --- variable creation ---------------------------------------------
    def create_parameter(self, attr, shape, dtype, is_bias=False, default_initializer=None):
        assert isinstance(attr, ParamAttr)
        suffix = "b" if is_bias else "w"
        if attr.name is None:
            attr.name = unique_name(".".join([self.name, suffix]))
        if default_initializer is None:
            if is_bias:
                attr.set_default_bias_initializer()
            else:
                attr.set_default_param_initializer()
        else:
            attr.set_default_initializer(default_initializer)

        # startup program gets the var + its init op
        startup_block = self.startup_program.global_block()
        startup_block.create_parameter(
            dtype=dtype,
            shape=shape,
            **attr.to_kwargs(with_initializer=True),
        )
        # main program gets the var only
        return self.main_program.global_block().create_parameter(
            dtype=dtype, shape=shape, **attr.to_kwargs()
        )

    def get_parameter(self, name):
        """Look up an existing Parameter by name (reference layer_helper
        get_parameter; used by crf_decoding to share the CRF transitions)."""
        param = self.main_program.global_block().var(name)
        from .core.program import Parameter

        if not isinstance(param, Parameter):
            raise ValueError("variable %r is not a Parameter" % name)
        return param

    def create_tmp_variable(self, dtype, stop_gradient=False, shape=None, lod_level=0):
        return self.main_program.current_block().create_var(
            name=unique_name(".".join([self.name, "tmp"])),
            dtype=dtype,
            shape=shape,
            lod_level=lod_level,
            persistable=False,
            stop_gradient=stop_gradient,
        )

    def create_variable(self, *args, **kwargs):
        return self.main_program.current_block().create_var(*args, **kwargs)

    def create_global_variable(self, persistable=False, *args, **kwargs):
        return self.main_program.global_block().create_var(
            *args, persistable=persistable, **kwargs
        )

    def set_variable_initializer(self, var, initializer):
        self.startup_program.global_block().create_var(
            name=var.name,
            dtype=var.dtype,
            shape=var.shape,
            persistable=True,
            initializer=initializer,
        )

    # --- tails ----------------------------------------------------------
    def append_bias_op(self, input_var, dim_start=1, dim_end=None):
        """Add a bias over dims [dim_start, dim_end) of the input
        (reference layer_helper.py append_bias_op)."""
        size = list(input_var.shape[dim_start:dim_end])
        bias_attr = self.bias_attr
        if not bias_attr:
            return input_var
        b = self.create_parameter(
            attr=bias_attr, shape=size, dtype=input_var.dtype, is_bias=True
        )
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(
            type="elementwise_add",
            inputs={"X": [input_var], "Y": [b]},
            outputs={"Out": [tmp]},
            attrs={"axis": dim_start},
        )
        return tmp

    def append_activation(self, input_var):
        act = self.kwargs.get("act")
        if act is None:
            return input_var
        if isinstance(act, str):
            act = {"type": act}
        else:
            act = dict(act)
        act_type = act.pop("type")
        tmp = self.create_tmp_variable(dtype=input_var.dtype)
        self.append_op(
            type=act_type,
            inputs={"X": [input_var]},
            outputs={"Out": [tmp]},
            attrs=act,
        )
        return tmp
