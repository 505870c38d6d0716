"""Gradient / error clipping (reference python/paddle/v2/fluid/clip.py:
ErrorClipByValue, GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip, append_gradient_clip_ops)."""

from __future__ import annotations

from . import layers

__all__ = [
    "ErrorClipByValue",
    "GradientClipByValue",
    "GradientClipByNorm",
    "GradientClipByGlobalNorm",
    "BaseGradientClipAttr",
    "NullGradientClipAttr",
    "append_gradient_clip_ops",
    "error_clip_callback",
    "set_gradient_clip",
]


class BaseErrorClipAttr(object):
    def append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = -max if min is None else float(min)
        self.max, self.min = max, min

    def append_clip_op(self, block, grad_name):
        block.append_op(
            type="clip",
            inputs={"X": [grad_name]},
            outputs={"Out": [grad_name]},
            attrs={"min": self.min, "max": self.max},
        )


def error_clip_callback(block, context):
    pass  # activation-gradient clipping is folded into the vjp lowering


class BaseGradientClipAttr(object):
    def process_context(self, context, param, grad):
        pass

    def create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        min = -max if min is None else float(min)
        self.max, self.min = max, min

    def create_operators(self, param, grad):
        new_grad = layers.clip(x=grad, min=self.min, max=self.max)
        return param, new_grad


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def create_operators(self, param, grad):
        new_grad = layers.clip_by_norm(x=grad, max_norm=self.clip_norm)
        return param, new_grad


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def process_context(self, context, param, grad):
        if self.group_name not in context:
            context[self.group_name] = []
            context[self.group_name + "_clip_value"] = self.clip_norm
        context[self.group_name].append(
            layers.reduce_sum(input=layers.pow(x=grad, factor=2.0))
        )

    def create_operators(self, param, grad):
        # the group scale lives in the per-minimize context dict (NOT on
        # the instance) so one clip object can serve several programs
        group_scale_name = self.group_name + "_scale"
        if group_scale_name not in self._context:
            group_norm = layers.sums(input=self._context[self.group_name])
            group_norm = layers.sqrt(x=group_norm)
            clip_var = layers.fill_constant(
                shape=[1], dtype="float32", value=self.clip_norm
            )
            self._context[group_scale_name] = layers.elementwise_div(
                x=clip_var,
                y=layers.elementwise_max(x=clip_var, y=group_norm),
            )
        new_grad = layers.elementwise_mul(x=grad, y=self._context[group_scale_name])
        return param, new_grad


def set_gradient_clip(clip, param_list=None, program=None):
    from .core.program import default_main_program
    from .param_attr import ParamAttr

    if program is None:
        program = default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    param_list = [
        program.global_block().var(p) if isinstance(p, str) else p for p in param_list
    ]
    for param in param_list:
        param.gradient_clip_attr = clip


def append_gradient_clip_ops(param_grad):
    context = {}
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clip_attr.process_context(context=context, param=p, grad=g)
    res = []
    for p, g in param_grad:
        clip_attr = getattr(p, "gradient_clip_attr", None) or NullGradientClipAttr()
        clip_attr._context = context
        res.append(clip_attr.create_operators(param=p, grad=g))
    return res
