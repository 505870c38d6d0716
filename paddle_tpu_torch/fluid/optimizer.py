"""Optimizers as graph rewrites (reference python/paddle/v2/fluid/optimizer.py
and the op-level math in operators/{sgd,momentum,adagrad,adam,adamax,
decayed_adagrad,rmsprop,adadelta,ftrl}_op.cc; legacy parity:
paddle/parameter/FirstOrderOptimizer.h).

`minimize` appends the autodiff marker (backward.py), regularization +
clipping rewrites on gradient vars, then one optimizer-update op per
parameter. The executor runs the forward region, one autograd pass
for the gradients, then these ops in place on the scope's tensors
(core/lowering.py). `ModelAverage` keeps sliding-window sums of the
iterates through the `average_accumulates` op and swaps their mean in
for evaluation; `StaticPruning` holds a fixed magnitude mask on the
parameters it prunes.
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


class ModelAverage(object):
    """Averaged parameters (reference parameter/AverageOptimizer.cpp and
    the trainer's catchUp/apply/restore dance, v2/trainer.py:130):
    evaluation and export use a sliding-window arithmetic mean of the
    weight iterates rather than the last SGD iterate.

    Three per-param sum accumulators and counters are updated inside
    every train step by the `average_accumulates` op (core/
    kernels_optim.py: the selects of AverageOptimizer.cpp:60-115, no
    host read). The averaged value is the exact mean
    of the last [W, 2W] iterates where W = clamp(num_updates *
    average_window, min_average_window, max_average_window) — the
    window guarantee TrainerConfig.proto:70-75 documents.

    `average_window` is the RATE of updates to average (reference
    optConfig.average_window, e.g. 0.15); `apply()` is a context
    manager that swaps (sum_1+sum_2+sum_3)/(num+old_num) into the scope
    for eval/save and restores the live weights after.

    Call `build(program)` AFTER optimizer.minimize, inside the same
    program_guard. Inside `apply()` run a for_test clone (or any
    inference program): running the TRAINING program there would train
    onward from the averaged weights.
    """

    SUM_SUFFIXES = ("@SUM_1", "@SUM_2", "@SUM_3")
    CNT_SUFFIXES = ("@NUM_ACC", "@OLD_NUM_ACC", "@NUM_UPD")

    def __init__(self, average_window=0.15, min_average_window=100,
                 max_average_window=10000):
        self.average_window = float(average_window)
        self.min_average_window = int(min_average_window)
        self.max_average_window = int(max_average_window)
        self._param_names = []
        self._steps_name = None

    def _slot(self, pname, suffix):
        return pname + suffix

    def build(self, program=None):
        program = program or default_main_program()
        if program is not default_main_program():
            # the var initializers land in the CURRENT guard's programs;
            # a mismatched program would get ops whose vars live (and
            # initialize) elsewhere
            raise ValueError(
                "ModelAverage.build must run inside program_guard of the "
                "program it averages"
            )
        block = program.global_block()
        steps = tensor_layers.create_global_var(
            name=unique_name("model_average_steps"), shape=[1], value=0.0,
            dtype="float32", persistable=True,
        )
        self._steps_name = steps.name
        block.append_op(
            type="increment", inputs={"X": [steps]},
            outputs={"Out": [steps]}, attrs={"step": 1.0},
        )
        for p in block.all_parameters():
            # ParamAttr(do_model_average=False) opts a parameter out
            if not p.trainable or getattr(p, "do_model_average", True) is False:
                continue
            sums = []
            for sfx in self.SUM_SUFFIXES:
                v = tensor_layers.create_global_var(
                    name=self._slot(p.name, sfx), shape=list(p.shape),
                    value=0.0, dtype=p.dtype, persistable=True,
                )
                sums.append(v)
            cnts = [
                tensor_layers.create_global_var(
                    name=self._slot(p.name, sfx), shape=[1], value=0,
                    dtype="int32", persistable=True,
                )
                for sfx in self.CNT_SUFFIXES
            ]
            self._param_names.append(p.name)
            block.append_op(
                type="average_accumulates",
                inputs={
                    "Param": [p],
                    "InSum1": [sums[0]], "InSum2": [sums[1]],
                    "InSum3": [sums[2]],
                    "InNumAccumulates": [cnts[0]],
                    "InOldNumAccumulates": [cnts[1]],
                    "InNumUpdates": [cnts[2]],
                },
                outputs={
                    "OutSum1": [sums[0]], "OutSum2": [sums[1]],
                    "OutSum3": [sums[2]],
                    "OutNumAccumulates": [cnts[0]],
                    "OutOldNumAccumulates": [cnts[1]],
                    "OutNumUpdates": [cnts[2]],
                },
                attrs={
                    "average_window": self.average_window,
                    "min_average_window": self.min_average_window,
                    "max_average_window": self.max_average_window,
                },
            )
        return self

    def attach(self, scope):
        """Adopt the averaging slots of a LOADED scope (a checkpoint
        trained with averaging) so apply() works without rebuilding the
        training graph. Returns self; slots may be empty if the
        checkpoint carried none."""
        sfx = self.SUM_SUFFIXES[0]
        self._param_names = sorted(
            k[: -len(sfx)] for k in scope.keys() if k.endswith(sfx)
        )
        # bind the steps counter by its exact name family
        # ("model_average_steps" + unique_name suffix). A scope holding
        # MORE than one such var (e.g. a program rebuilt twice into one
        # scope) is ambiguous — binding the wrong counter would silently
        # skew the average, so refuse instead of guessing.
        steps = sorted(
            k for k in scope.keys()
            if k == "model_average_steps"
            or k.startswith("model_average_steps_")
        )
        if len(steps) > 1:
            raise ValueError(
                "scope holds %d model_average_steps counters (%r); "
                "cannot tell which matches the averaged slots — load a "
                "checkpoint produced by a single minimize(), or delete "
                "the stale counters" % (len(steps), steps)
            )
        self._steps_name = steps[0] if steps else None
        return self

    def apply(self, scope=None, need_restore=True):
        """Context manager: swap window-averaged weights into the scope
        (eval/save run on averages), restore live weights on exit.
        Average = (sum_1+sum_2+sum_3)/(num_accumulates +
        old_num_accumulates) — AverageOptimizer.cpp:117 apply(). The
        sums are added in float64 on the weights' device, as the JAX
        package adds them in numpy; restore puts the live tensors back
        themselves, so they come back bit for bit."""
        import contextlib

        import torch

        from .executor import global_scope

        def count(v):
            return int(torch.as_tensor(v).reshape(-1)[0])

        @contextlib.contextmanager
        def _ctx():
            sc = scope or global_scope()
            t = float(torch.as_tensor(sc.get(self._steps_name)).reshape(-1)[0])
            if t < 1.0:
                raise RuntimeError(
                    "ModelAverage.apply before any training step: the "
                    "averages are still zero"
                )
            saved = {}
            for pname in self._param_names:
                saved[pname] = sc.get(pname)
                live = torch.as_tensor(saved[pname])
                s = sum(
                    torch.as_tensor(sc.get(self._slot(pname, sfx))).to(
                        live.device, torch.float64)
                    for sfx in self.SUM_SUFFIXES
                )
                n = count(sc.get(self._slot(pname, "@NUM_ACC"))) + count(
                    sc.get(self._slot(pname, "@OLD_NUM_ACC")))
                sc.set(pname, (s / max(n, 1)).to(live.dtype))
            try:
                yield
            finally:
                if need_restore:
                    for pname, val in saved.items():
                        sc.set(pname, val)

        return _ctx()


__all__.append("ModelAverage")


class StaticPruning(object):
    """Static magnitude pruning hook (reference
    parameter/ParameterUpdaterHook.cpp:39 StaticPruningHook /
    HookAttr(type='pruning', sparsity_ratio=...)): a fixed mask keeps the
    largest-|w| (1 - sparsity) fraction of each hooked parameter; every
    update re-applies the mask so pruned weights stay exactly zero.

    The mask is computed IN the startup program (abs -> top_k -> a
    scatter of ones at the kept indices; `top_k` is a stable sort, so
    tied magnitudes prune an exact fraction), stored as a persistable
    `@PRUNE_MASK` slot, applied once at init and then by graph ops
    appended after the optimizer update — all on the device, no host
    work.

    Call build(program, startup_program) AFTER minimize and BEFORE
    running the startup program, inside the same program_guard. Parameters are discovered from their
    ParamAttr(update_hook=...) spec (any object with type='pruning' and
    sparsity_ratio), or passed explicitly via `targets`.
    """

    MASK_SUFFIX = "@PRUNE_MASK"

    def __init__(self, sparsity_ratio=None):
        self.sparsity_ratio = sparsity_ratio
        self.masks = {}
        self._built_ratio = {}

    DEFAULT_RATIO = 0.6  # reference ParameterUpdaterHookConfig default

    @staticmethod
    def _hook_ratio(p):
        hook = getattr(p, "update_hook", None)
        if hook is None:
            return None
        hooks = hook if isinstance(hook, (list, tuple)) else [hook]
        for h in hooks:
            if getattr(h, "type", None) == "pruning":
                r = getattr(h, "sparsity_ratio", None)
                return (
                    float(r) if r is not None
                    else StaticPruning.DEFAULT_RATIO
                )
        return None

    def build(self, program=None, startup_program=None, targets=None):
        import numpy as _np

        program = program or default_main_program()
        startup = startup_program or default_startup_program()
        block = program.global_block()
        sblock = startup.global_block()

        if targets is not None:
            if self.sparsity_ratio is None:
                raise ValueError(
                    "build(targets=...) needs StaticPruning("
                    "sparsity_ratio=...)"
                )
            plan = [(p, float(self.sparsity_ratio)) for p in targets]
        else:
            plan = [
                (p, r)
                for p in block.all_parameters()
                for r in [self._hook_ratio(p)]
                if r is not None
            ]
        for p, ratio in plan:
            if not (0.0 < ratio < 1.0):
                raise ValueError(
                    "sparsity_ratio must be in (0, 1), got %r for %s"
                    % (ratio, p.name)
                )
            numel = int(_np.prod(p.shape))
            keep = max(1, int(round(numel * (1.0 - ratio))))
            self._built_ratio[p.name] = ratio
            mask = block.create_var(
                name=p.name + self.MASK_SUFFIX, shape=list(p.shape),
                dtype=p.dtype, persistable=True,
            )
            # mirror into startup so its ops may write it there
            smask = sblock.create_var(
                name=mask.name, shape=list(p.shape), dtype=p.dtype,
                persistable=True,
            )
            def stmp(suffix, shape, dtype=p.dtype):
                return sblock.create_var(
                    name=unique_name(p.name + suffix), shape=list(shape),
                    dtype=dtype,
                )

            # |w| -> flat [1, numel] -> top_k(keep) -> threshold
            a = stmp("@abs", p.shape)
            sblock.append_op(type="abs", inputs={"X": [p.name]},
                             outputs={"Out": [a]}, attrs={})
            flat = stmp("@flat", [1, numel])
            sblock.append_op(type="reshape", inputs={"X": [a]},
                             outputs={"Out": [flat]},
                             attrs={"shape": [1, numel]})
            vals = stmp("@topk", [1, keep])
            idx = stmp("@topki", [1, keep], dtype="int32")
            sblock.append_op(type="top_k", inputs={"X": [flat]},
                             outputs={"Out": [vals], "Indices": [idx]},
                             attrs={"k": keep})
            # mask by INDEX (exactly `keep` survivors even under ties —
            # a threshold compare would keep every tied value)
            zeros = stmp("@zeros", [numel])
            sblock.append_op(type="fill_constant", inputs={},
                             outputs={"Out": [zeros]},
                             attrs={"shape": [numel], "value": 0.0,
                                    "dtype": p.dtype})
            ones = stmp("@ones", [keep])
            sblock.append_op(type="fill_constant", inputs={},
                             outputs={"Out": [ones]},
                             attrs={"shape": [keep], "value": 1.0,
                                    "dtype": p.dtype})
            maskf = stmp("@maskf", [numel])
            sblock.append_op(type="scatter",
                             inputs={"X": [zeros], "Ids": [idx],
                                     "Updates": [ones]},
                             outputs={"Out": [maskf]}, attrs={})
            sblock.append_op(type="reshape", inputs={"X": [maskf]},
                             outputs={"Out": [smask]},
                             attrs={"shape": list(p.shape)})
            # sparsify the initial weights too
            pruned0 = stmp("@p0", p.shape)
            sblock.append_op(type="elementwise_mul",
                             inputs={"X": [p.name], "Y": [smask]},
                             outputs={"Out": [pruned0]}, attrs={})
            sblock.append_op(type="assign", inputs={"X": [pruned0]},
                             outputs={"Out": [p.name]}, attrs={})

            # main program: re-apply after every optimizer update
            t = block.create_var(
                name=unique_name(p.name + "@pruned"), shape=list(p.shape),
                dtype=p.dtype,
            )
            block.append_op(type="elementwise_mul",
                            inputs={"X": [p.name], "Y": [mask]},
                            outputs={"Out": [t]}, attrs={})
            block.append_op(type="assign", inputs={"X": [t]},
                            outputs={"Out": [p.name]}, attrs={})
            self.masks[p.name] = mask.name
        return self

    def recompute(self, scope):
        """Rebuild masks from the CURRENT scope values (host-side) and
        sparsify — for weights loaded from a checkpoint AFTER startup
        ran (the in-startup mask would reflect the discarded random
        init)."""
        import numpy as _np

        from .executor import as_numpy

        for pname, mname in self.masks.items():
            if pname not in scope:
                continue
            w = as_numpy(scope.get(pname))
            flat = _np.abs(w).ravel()
            keep = max(1, int(round(
                flat.size * (1.0 - self._built_ratio[pname])
            )))
            idx = _np.argpartition(-flat, keep - 1)[:keep]
            mask = _np.zeros_like(flat)
            mask[idx] = 1.0
            mask = mask.reshape(w.shape)
            scope.set(mname, mask.astype(w.dtype))
            scope.set(pname, (w * mask).astype(w.dtype))
        return self


__all__.append("StaticPruning")
