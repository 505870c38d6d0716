"""ParamAttr (reference python/paddle/v2/fluid/param_attr.py)."""

from __future__ import annotations

from .initializer import Constant, Initializer, Xavier

__all__ = ["ParamAttr", "WeightNormParamAttr"]


class ParamAttr(object):
    def __init__(
        self,
        name=None,
        initializer=None,
        learning_rate=1.0,
        regularizer=None,
        trainable=True,
        gradient_clip=None,
        do_model_average=None,
        update_hook=None,
    ):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.gradient_clip = gradient_clip
        self.do_model_average = do_model_average
        self.update_hook = update_hook

    def set_default_initializer(self, initializer):
        if self.initializer is None:
            self.initializer = initializer

    def set_default_param_initializer(self):
        self.set_default_initializer(Xavier())

    def set_default_bias_initializer(self):
        self.set_default_initializer(Constant(0.0))

    @staticmethod
    def to_attr(arg):
        if arg is None:
            return ParamAttr()
        if isinstance(arg, (list, tuple)):
            return [ParamAttr.to_attr(a) for a in arg]
        if isinstance(arg, ParamAttr):
            return arg
        if isinstance(arg, str):
            return ParamAttr(name=arg)
        if isinstance(arg, Initializer):
            return ParamAttr(initializer=arg)
        if isinstance(arg, bool):
            return ParamAttr() if arg else None
        raise TypeError("cannot interpret %r as ParamAttr" % (arg,))

    def to_kwargs(self, with_initializer=False):
        kwargs = {
            "name": self.name,
            "optimize_attr": {"learning_rate": self.learning_rate},
            "regularizer": self.regularizer,
            "trainable": self.trainable,
            "gradient_clip_attr": self.gradient_clip,
            "do_model_average": self.do_model_average,
            "update_hook": self.update_hook,
        }
        if with_initializer:
            kwargs["initializer"] = self.initializer
        return kwargs


class WeightNormParamAttr(ParamAttr):
    def __init__(self, dim=None, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
