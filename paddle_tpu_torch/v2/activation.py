"""Activation objects (reference paddle.v2.activation / trainer_config_
helpers.activations). Each instance names the fluid activation to apply."""

__all__ = [
    "Tanh", "Sigmoid", "Softmax", "Identity", "Linear", "Relu", "BRelu",
    "SoftRelu", "STanh", "Abs", "Square", "Exp", "Log", "SquareRootN",
    "Reciprocal",
]


class BaseActivation(object):
    name = None

    def __repr__(self):
        return "activation.%s" % type(self).__name__


def _make(cls_name, act_name):
    cls = type(cls_name, (BaseActivation,), {"name": act_name})
    return cls


Tanh = _make("Tanh", "tanh")
Sigmoid = _make("Sigmoid", "sigmoid")
Softmax = _make("Softmax", "softmax")
Identity = _make("Identity", None)
Linear = Identity
Relu = _make("Relu", "relu")
BRelu = _make("BRelu", "brelu")
SoftRelu = _make("SoftRelu", "soft_relu")
STanh = _make("STanh", "stanh")
Abs = _make("Abs", "abs")
Square = _make("Square", "square")
Exp = _make("Exp", "exp")
Log = _make("Log", "log")
Reciprocal = _make("Reciprocal", "reciprocal")
SquareRootN = _make("SquareRootN", "sqrt")
