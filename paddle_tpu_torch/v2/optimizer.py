"""v2 optimizer wrappers mapping onto fluid optimizers (reference
python/paddle/v2/optimizer.py wraps the C++ ParameterUpdater family;
SURVEY.md N4/N7 — every update strategy is the program's own optimizer
ops, run by the executor after the backward)."""

from __future__ import annotations

from .. import fluid

__all__ = ["Momentum", "Adam", "Adamax", "AdaGrad", "DecayedAdaGrad",
           "AdaDelta", "RMSProp", "SGD"]


class Optimizer(object):
    # settings-objects shared across the update equations: v2 configs
    # pass model_average=ModelAverage(...) / regularization through the
    # optimizer ctor (reference v2/optimizer.py kwargs)
    model_average = None

    def _capture(self, kwargs):
        self.model_average = kwargs.get("model_average")

    def _fluid(self):
        raise NotImplementedError


class SGD(Optimizer):
    def __init__(self, learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.SGD(learning_rate=self.learning_rate)


class Momentum(Optimizer):
    def __init__(self, momentum=0.9, learning_rate=1e-3, sparse=False, **kwargs):
        self._capture(kwargs)
        self.momentum = momentum
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.Momentum(
            learning_rate=self.learning_rate, momentum=self.momentum
        )


class Adam(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, epsilon=1e-8,
                 learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.Adam(
            learning_rate=self.learning_rate, beta1=self.beta1,
            beta2=self.beta2, epsilon=self.epsilon,
        )


class Adamax(Optimizer):
    def __init__(self, beta1=0.9, beta2=0.999, learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.beta1, self.beta2 = beta1, beta2
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.Adamax(
            learning_rate=self.learning_rate, beta1=self.beta1, beta2=self.beta2
        )


class AdaGrad(Optimizer):
    def __init__(self, learning_rate=1e-3, epsilon=1e-6, **kwargs):
        self._capture(kwargs)
        self.learning_rate, self.epsilon = learning_rate, epsilon

    def _fluid(self):
        return fluid.optimizer.Adagrad(
            learning_rate=self.learning_rate, epsilon=self.epsilon
        )


class DecayedAdaGrad(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.DecayedAdagrad(
            learning_rate=self.learning_rate, decay=self.rho,
            epsilon=self.epsilon,
        )


class AdaDelta(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.Adadelta(
            learning_rate=self.learning_rate, rho=self.rho,
            epsilon=self.epsilon,
        )


class RMSProp(Optimizer):
    def __init__(self, rho=0.95, epsilon=1e-6, learning_rate=1e-3, **kwargs):
        self._capture(kwargs)
        self.rho, self.epsilon = rho, epsilon
        self.learning_rate = learning_rate

    def _fluid(self):
        return fluid.optimizer.RMSProp(
            learning_rate=self.learning_rate, rho=self.rho,
            epsilon=self.epsilon,
        )


# settings-objects shared with the legacy DSL (reference v2/optimizer.py
# aliases the trainer_config_helpers implementations the same way)
from ..trainer_config_helpers import (  # noqa: E402,F401
    L2Regularization,
    ModelAverage,
)

__all__ += ["ModelAverage", "L2Regularization"]
