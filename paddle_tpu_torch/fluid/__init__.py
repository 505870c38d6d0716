"""paddle_tpu_torch.fluid — the Fluid Program/Executor framework on
PyTorch (counterpart of paddle_tpu.fluid, with the same Python API).

A program built with these layers runs through `Executor`, on the card
by default (`Executor()`, `CUDAPlace(i)`; raising where there is none)
or on the CPU when asked (`CPUPlace()`). The slice ported so far: the
IR, the executor and autograd backward, every op kernel the JAX package
registers, the layers of io, nn, tensor and ops, the optimizers (with
`ModelAverage` and `StaticPruning`), regularizers, clipping and model
save/load in the JAX package's on-disk format; LoD (ragged) feeds, the
sequence ops, the dynamic LSTM and GRU, CTC, `nets`, `DataFeeder` and
`AsyncDeviceFeeder`; control flow (While, tensor arrays, DynamicRNN,
IfElse, Switch, StaticRNN, beam search) and 2-level LoD feeds;
SelectedRows sparse gradients, nce, hsigmoid and auc; the CRF ops, the
detection ops and layers, the learning-rate schedules
(`learning_rate_decay`) and the evaluators (`evaluator`);
`memory_optimize`, `Executor.run_grad_accum`, the program verifier
(`run(validate=True)`), the numerics guard, the `profiler`, `debugger`,
`op`, `default_scope_funcs`, `net_drawer` and `graphviz`; the mesh
executor (`Executor(mesh=...)`: data-, tensor- and FSDP-parallel
programs, `run_async_local`, row-sharded tables; parallel/mesh.py) and
the distribute transpiler with the pserver shims of `layers.io`.
"""

from . import core
from . import framework
from . import layers
from . import nets
from . import optimizer
from . import backward
from . import regularizer
from . import initializer
from . import clip
from . import evaluator
from . import io
from . import profiler
from . import learning_rate_decay
from . import distribute_transpiler
from . import memory_optimization_transpiler
from . import debugger
from . import debugger as debuger  # reference module name (sic)

from .framework import (
    Program,
    Variable,
    Parameter,
    default_main_program,
    default_startup_program,
    program_guard,
    get_var,
)
from .core import CPUPlace, CUDAPlace, TPUPlace
from .executor import (
    Executor,
    Scope,
    global_scope,
    scope_guard,
    switch_scope,
    fetch_var,
    as_numpy,
    scope_from_numpy,
    scope_to_numpy,
)
from .data_feeder import DataFeeder
from .distribute_transpiler import (DistributeTranspiler,
                                    SimpleDistributeTranspiler)
from .memory_optimization_transpiler import memory_optimize, release_memory
from .param_attr import ParamAttr, WeightNormParamAttr
from .initializer import Constant, Normal, TruncatedNormal, Uniform, Xavier, MSRA
from .optimizer import (
    SGD,
    Momentum,
    Adagrad,
    Adam,
    Adamax,
    DecayedAdagrad,
    RMSProp,
    Adadelta,
    Ftrl,
    SGDOptimizer,
    MomentumOptimizer,
    AdagradOptimizer,
    AdamOptimizer,
    AdamaxOptimizer,
    DecayedAdagradOptimizer,
    RMSPropOptimizer,
    AdadeltaOptimizer,
    FtrlOptimizer,
)
from .backward import append_backward, calc_gradient
from .regularizer import L1Decay, L2Decay, L1DecayRegularizer, L2DecayRegularizer
from .clip import (
    ErrorClipByValue,
    GradientClipByValue,
    GradientClipByNorm,
    GradientClipByGlobalNorm,
)

__all__ = [
    "io",
    "evaluator",
    "learning_rate_decay",
    "initializer",
    "layers",
    "nets",
    "optimizer",
    "backward",
    "calc_gradient",
    "regularizer",
    "profiler",
    "clip",
    "memory_optimize",
    "release_memory",
    "Program",
    "Variable",
    "Parameter",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "Executor",
    "Scope",
    "global_scope",
    "scope_guard",
    "fetch_var",
    "scope_from_numpy",
    "scope_to_numpy",
    "DataFeeder",
    "DistributeTranspiler",
    "SimpleDistributeTranspiler",
    "ParamAttr",
    "WeightNormParamAttr",
    "CPUPlace",
    "CUDAPlace",
    "TPUPlace",
    "append_backward",
]
