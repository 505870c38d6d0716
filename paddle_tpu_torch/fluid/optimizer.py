"""Optimizers as graph rewrites (reference python/paddle/v2/fluid/optimizer.py
and the op-level math in operators/{sgd,momentum,adagrad,adam,adamax,
decayed_adagrad,rmsprop,adadelta,ftrl}_op.cc; legacy parity:
paddle/parameter/FirstOrderOptimizer.h).

`minimize` appends the autodiff marker (backward.py), regularization +
clipping rewrites on gradient vars, then one optimizer-update op per
parameter. The executor runs the forward region, one autograd pass
for the gradients, then these ops in place on the scope's tensors
(core/lowering.py). `ModelAverage` and `StaticPruning` are not ported
yet (ROADMAP, Queue A).
"""

from __future__ import annotations

from collections import defaultdict

from .backward import append_backward
from .clip import append_gradient_clip_ops, error_clip_callback
from .core.program import Program, Variable, default_main_program, default_startup_program, unique_name
from .initializer import Constant
from .layer_helper import LayerHelper
from .layers import tensor as tensor_layers
from .regularizer import append_regularization_ops

__all__ = [
    "Optimizer",
    "SGD",
    "Momentum",
    "Adagrad",
    "Adam",
    "Adamax",
    "DecayedAdagrad",
    "RMSProp",
    "Adadelta",
    "Ftrl",
    "SGDOptimizer",
    "MomentumOptimizer",
    "AdagradOptimizer",
    "AdamOptimizer",
    "AdamaxOptimizer",
    "DecayedAdagradOptimizer",
    "RMSPropOptimizer",
    "AdadeltaOptimizer",
    "FtrlOptimizer",
]


class Optimizer(object):
    def __init__(self, learning_rate, global_step=None, regularization=None):
        if not isinstance(learning_rate, (float, Variable)):
            raise TypeError("learning rate should be float or Variable")
        self._global_step = global_step
        self.regularization = regularization
        self._global_learning_rate = learning_rate
        self._learning_rate_var = None
        # {accum_name: {param_name: accum_var}}
        self._accumulators = defaultdict(dict)
        self.helper = None

    # --- learning rate --------------------------------------------------
    def _create_global_learning_rate(self):
        if isinstance(self._global_learning_rate, Variable):
            self._learning_rate_var = self._global_learning_rate
            return
        if self._learning_rate_var is None:
            self._learning_rate_var = tensor_layers.create_global_var(
                name=unique_name("learning_rate"),
                shape=[1],
                value=float(self._global_learning_rate),
                dtype="float32",
                persistable=True,
            )

    def global_learning_rate(self):
        return self._learning_rate_var

    def _create_param_lr(self, param_and_grad):
        param_lr = param_and_grad[0].optimize_attr.get("learning_rate", 1.0)
        if param_lr == 1.0:
            return self._learning_rate_var
        from .layers import ops as op_layers

        return op_layers.scale(x=self._learning_rate_var, scale=float(param_lr))

    # --- accumulators ---------------------------------------------------
    def _create_accumulators(self, block, parameters):
        pass

    def _finish_update(self, block):
        pass

    def _add_accumulator(self, name, param, dtype=None, fill_value=0.0, shape=None):
        if param.name in self._accumulators[name]:
            raise RuntimeError("accumulator %s for %s already exists" % (name, param.name))
        if shape is None:
            shape = param.shape
        assert self.helper is not None
        var = self.helper.create_global_variable(
            name=unique_name(name + "_" + param.name),
            persistable=True,
            dtype=dtype or param.dtype,
            shape=shape,
        )
        self.helper.set_variable_initializer(
            var, initializer=Constant(value=float(fill_value))
        )
        # tensor parallelism: a same-shaped optimizer slot of a sharded
        # parameter must live on the same mesh spec (parallel/mesh.py
        # shard_parameter) — inherit it so users annotate only the param
        prog = var.block.program
        spec = prog.shardings.get(param.name)
        if spec is not None and tuple(shape) == tuple(param.shape):
            prog.shardings[var.name] = spec
        self._accumulators[name][param.name] = var
        return var

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _increment_global_step(self, block):
        if self._global_step is None:
            return
        block.append_op(
            type="increment",
            inputs={"X": [self._global_step]},
            outputs={"Out": [self._global_step]},
            attrs={"step": 1.0},
        )

    # --- main entry points ---------------------------------------------
    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    def create_optimization_pass(self, parameters_and_grads, loss, startup_program=None):
        program = loss.block.program
        self.helper = LayerHelper(self.__class__.__name__)
        self._create_accumulators(
            loss.block, [p[0] for p in parameters_and_grads if p[0].trainable]
        )
        self._create_global_learning_rate()

        optimize_ops = []
        for param_and_grad in parameters_and_grads:
            if param_and_grad[0].trainable and param_and_grad[1] is not None:
                optimize_ops.append(
                    self._append_optimize_op(loss.block, param_and_grad)
                )
        self._finish_update(loss.block)
        self._increment_global_step(loss.block)
        return optimize_ops

    def minimize(self, loss, startup_program=None, parameter_list=None, no_grad_set=None):
        params_grads = append_backward(
            loss, parameter_list, no_grad_set, [error_clip_callback]
        )
        params_grads = append_gradient_clip_ops(params_grads)
        params_grads = append_regularization_ops(params_grads, self.regularization)
        optimize_ops = self.create_optimization_pass(
            params_grads, loss, startup_program
        )
        return optimize_ops, params_grads


class SGDOptimizer(Optimizer):
    def __init__(self, learning_rate, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "sgd"

    def _append_optimize_op(self, block, param_and_grad):
        return block.append_op(
            type="sgd",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]]},
        )


class MomentumOptimizer(Optimizer):
    _velocity_acc_str = "velocity"

    def __init__(self, learning_rate, momentum, use_nesterov=False, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "momentum"
        self._momentum = momentum
        self._use_nesterov = bool(use_nesterov)

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._velocity_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        velocity_acc = self._get_accumulator(self._velocity_acc_str, param_and_grad[0])
        return block.append_op(
            type="momentum",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Velocity": [velocity_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "VelocityOut": [velocity_acc],
            },
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov},
        )


class AdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, epsilon=1.0e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adagrad"
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="adagrad",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [moment_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment_acc]},
            attrs={"epsilon": self._epsilon},
        )


class AdamOptimizer(Optimizer):
    _moment1_acc_str = "moment1"
    _moment2_acc_str = "moment2"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adam"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow_acc = None
        self._beta2_pow_acc = None

    def _create_accumulators(self, block, parameters):
        main_block = block.program.global_block()
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name("beta1_pow_acc"),
            dtype="float32",
            shape=[1],
            persistable=True,
        )
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1)
        )
        self._beta2_pow_acc = self.helper.create_global_variable(
            name=unique_name("beta2_pow_acc"),
            dtype="float32",
            shape=[1],
            persistable=True,
        )
        self.helper.set_variable_initializer(
            self._beta2_pow_acc, initializer=Constant(self._beta2)
        )
        for p in parameters:
            self._add_accumulator(self._moment1_acc_str, p)
            self._add_accumulator(self._moment2_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment1 = self._get_accumulator(self._moment1_acc_str, param_and_grad[0])
        moment2 = self._get_accumulator(self._moment2_acc_str, param_and_grad[0])
        return block.append_op(
            type="adam",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment1": [moment1],
                "Moment2": [moment2],
                "Beta1Pow": [self._beta1_pow_acc],
                "Beta2Pow": [self._beta2_pow_acc],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "Moment1Out": [moment1],
                "Moment2Out": [moment2],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block):
        """beta^t bookkeeping after all param updates (reference
        optimizer.py:437)."""
        block.append_op(
            type="scale",
            inputs={"X": [self._beta1_pow_acc]},
            outputs={"Out": [self._beta1_pow_acc]},
            attrs={"scale": self._beta1},
        )
        block.append_op(
            type="scale",
            inputs={"X": [self._beta2_pow_acc]},
            outputs={"Out": [self._beta2_pow_acc]},
            attrs={"scale": self._beta2},
        )


class AdamaxOptimizer(Optimizer):
    _moment_acc_str = "moment"
    _inf_norm_acc_str = "inf_norm"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adamax"
        self._beta1 = beta1
        self._beta2 = beta2
        self._epsilon = epsilon
        self._beta1_pow_acc = None

    def _create_accumulators(self, block, parameters):
        self._beta1_pow_acc = self.helper.create_global_variable(
            name=unique_name("beta1_pow_acc"),
            dtype="float32",
            shape=[1],
            persistable=True,
        )
        self.helper.set_variable_initializer(
            self._beta1_pow_acc, initializer=Constant(self._beta1)
        )
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._inf_norm_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        inf_norm = self._get_accumulator(self._inf_norm_acc_str, param_and_grad[0])
        return block.append_op(
            type="adamax",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "LearningRate": [self._create_param_lr(param_and_grad)],
                "Moment": [moment],
                "InfNorm": [inf_norm],
                "Beta1Pow": [self._beta1_pow_acc],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "MomentOut": [moment],
                "InfNormOut": [inf_norm],
            },
            attrs={
                "beta1": self._beta1,
                "beta2": self._beta2,
                "epsilon": self._epsilon,
            },
        )

    def _finish_update(self, block):
        block.append_op(
            type="scale",
            inputs={"X": [self._beta1_pow_acc]},
            outputs={"Out": [self._beta1_pow_acc]},
            attrs={"scale": self._beta1},
        )


class DecayedAdagradOptimizer(Optimizer):
    _moment_acc_str = "moment"

    def __init__(self, learning_rate, decay=0.95, epsilon=1.0e-6, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "decayed_adagrad"
        self._decay = decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        moment_acc = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        return block.append_op(
            type="decayed_adagrad",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [moment_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={"ParamOut": [param_and_grad[0]], "MomentOut": [moment_acc]},
            attrs={"decay": self._decay, "epsilon": self._epsilon},
        )


class RMSPropOptimizer(Optimizer):
    _moment_acc_str = "momentum"
    _mean_square_acc_str = "mean_square"

    def __init__(self, learning_rate, rho=0.95, epsilon=1.0e-6, momentum=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "rmsprop"
        self._rho = rho
        self._epsilon = epsilon
        self._momentum = momentum

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._moment_acc_str, p)
            self._add_accumulator(self._mean_square_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        momentum_acc = self._get_accumulator(self._moment_acc_str, param_and_grad[0])
        mean_square_acc = self._get_accumulator(self._mean_square_acc_str, param_and_grad[0])
        return block.append_op(
            type="rmsprop",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "Moment": [momentum_acc],
                "MeanSquare": [mean_square_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "MomentOut": [momentum_acc],
                "MeanSquareOut": [mean_square_acc],
            },
            attrs={
                "epsilon": self._epsilon,
                "decay": self._rho,
                "momentum": self._momentum,
            },
        )


class AdadeltaOptimizer(Optimizer):
    _avg_squared_grad_acc_str = "_avg_squared_grad"
    _avg_squared_update_acc_str = "_avg_squared_update"

    def __init__(self, learning_rate, epsilon=1.0e-6, rho=0.95, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "adadelta"
        self._epsilon = epsilon
        self._rho = rho

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._avg_squared_grad_acc_str, p)
            self._add_accumulator(self._avg_squared_update_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        avg_squared_grad = self._get_accumulator(
            self._avg_squared_grad_acc_str, param_and_grad[0]
        )
        avg_squared_update = self._get_accumulator(
            self._avg_squared_update_acc_str, param_and_grad[0]
        )
        return block.append_op(
            type="adadelta",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "AvgSquaredGrad": [avg_squared_grad],
                "AvgSquaredUpdate": [avg_squared_update],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "AvgSquaredGradOut": [avg_squared_grad],
                "AvgSquaredUpdateOut": [avg_squared_update],
            },
            attrs={"epsilon": self._epsilon, "rho": self._rho},
        )


class FtrlOptimizer(Optimizer):
    _squared_acc_str = "squared"
    _linear_acc_str = "linear"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.type = "ftrl"
        self._l1 = l1
        self._l2 = l2
        self._lr_power = lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator(self._squared_acc_str, p)
            self._add_accumulator(self._linear_acc_str, p)

    def _append_optimize_op(self, block, param_and_grad):
        squared_acc = self._get_accumulator(self._squared_acc_str, param_and_grad[0])
        linear_acc = self._get_accumulator(self._linear_acc_str, param_and_grad[0])
        return block.append_op(
            type="ftrl",
            inputs={
                "Param": [param_and_grad[0]],
                "Grad": [param_and_grad[1]],
                "SquaredAccumulator": [squared_acc],
                "LinearAccumulator": [linear_acc],
                "LearningRate": [self._create_param_lr(param_and_grad)],
            },
            outputs={
                "ParamOut": [param_and_grad[0]],
                "SquaredAccumOut": [squared_acc],
                "LinearAccumOut": [linear_acc],
            },
            attrs={"l1": self._l1, "l2": self._l2, "lr_power": self._lr_power},
        )


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adagrad = AdagradOptimizer
Adam = AdamOptimizer
Adamax = AdamaxOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
RMSProp = RMSPropOptimizer
Adadelta = AdadeltaOptimizer
Ftrl = FtrlOptimizer

