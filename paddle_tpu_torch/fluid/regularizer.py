"""Weight-decay regularizers (reference python/paddle/v2/fluid/regularizer.py
+ legacy paddle/parameter/Regularizer.cpp). Applied as graph rewrites on the
gradient vars between the autodiff marker and the optimizer ops."""

from __future__ import annotations

from .core.program import grad_var_name

__all__ = [
    "append_regularization_ops",
    "WeightDecayRegularizer",
    "L1Decay",
    "L2Decay",
    "L1DecayRegularizer",
    "L2DecayRegularizer",
]


class WeightDecayRegularizer(object):
    def append_regularization_op(self, param, grad, block):
        raise NotImplementedError


class L2Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [param]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


class L1Decay(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self._regularization_coeff = regularization_coeff

    def append_regularization_op(self, param, grad, block):
        sign = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(type="sign", inputs={"X": [param]}, outputs={"Out": [sign]})
        decay = block.create_var(dtype=param.dtype, shape=param.shape)
        block.append_op(
            type="scale",
            inputs={"X": [sign]},
            outputs={"Out": [decay]},
            attrs={"scale": self._regularization_coeff},
        )
        return decay


L1DecayRegularizer = L1Decay
L2DecayRegularizer = L2Decay


def append_regularization_ops(params_grads, regularization=None):
    """grad += decay(param) for every param that has a regularizer attached
    (param-level regularizer wins over the optimizer-level default) —
    reference regularizer.py append_regularization_ops."""
    out = []
    for param, grad in params_grads:
        regularization_term = None
        reg = param.regularizer if param.regularizer is not None else regularization
        if grad is None or reg is None:
            out.append((param, grad))
            continue
        block = grad.block
        regularization_term = reg.append_regularization_op(param, grad, block)
        new_grad = block.create_var(
            name=grad.name + ".reg", dtype=param.dtype, shape=param.shape
        )
        block.append_op(
            type="sum",
            inputs={"X": [grad, regularization_term]},
            outputs={"Out": [new_grad]},
        )
        out.append((param, new_grad))
    return out
