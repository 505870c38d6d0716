"""paddle.v2-compatible API surface (counterpart of paddle_tpu/v2;
reference python/paddle/v2/__init__.py).

`import paddle_tpu_torch.v2 as paddle` gives the classic v2 workflow:

    paddle.init(use_gpu=False, trainer_count=1)
    x = paddle.layer.data(name='x', type=paddle.data_type.dense_vector(13))
    y = paddle.layer.fc(input=x, size=1)
    ...
    params = paddle.parameters.create(cost)
    trainer = paddle.trainer.SGD(cost=cost, parameters=params,
                                 update_equation=paddle.optimizer.Momentum(...))
    trainer.train(paddle.batch(paddle.reader.shuffle(...), 128), ...)

The engine underneath is the port's fluid Program + Executor. `init`
picks the device: the card by default (raising where there is none),
the CPU with `use_gpu=False`. Parameters, SGD and Inference run where
`init` said.

The modules that share their objects with the legacy DSL (`attr`,
`networks`, `pooling`, `optimizer`, `op`) load at first use: the DSL
imports this package's `layer`, so importing them here would close an
import cycle when the DSL is imported first.

`master` is the client of the coordinator's task queue
(`distributed.coordinator`); `reader.creator`'s record readers read the
JAX package's record files and shards. `dataset` holds the book's
readers (`paddle.dataset.mnist.train()` and the rest), `image` the image
transforms and `plot` the training-curve Ploter; PIL and matplotlib are
imported only where an image is decoded or a curve drawn, never here.
"""

import importlib

from . import activation  # noqa: F401
from . import data_type  # noqa: F401
from . import dataset  # noqa: F401
from . import evaluator  # noqa: F401
from . import event  # noqa: F401
from . import layer  # noqa: F401
from . import master  # noqa: F401
from . import minibatch  # noqa: F401
from . import parameters  # noqa: F401
from . import plot  # noqa: F401
from . import reader  # noqa: F401
from . import trainer  # noqa: F401
from .minibatch import batch  # noqa: F401
from .trainer import infer  # noqa: F401

# `import paddle.v2.fluid as fluid` parity: the fluid package is shared
from .. import fluid  # noqa: F401
from ..fluid import (  # noqa: F401
    default_main_program,
    default_startup_program,
)

__all__ = [
    "init", "batch", "infer", "layer", "activation", "data_type",
    "dataset", "evaluator", "event", "master", "minibatch", "optimizer",
    "parameters", "plot", "reader",
    "trainer", "attr", "pooling", "networks",
    "default_main_program", "default_startup_program",
    "fluid",
]

_LAZY = ("attr", "networks", "pooling", "optimizer", "op")

# where Parameters / SGD / Inference run: None is the card
_settings = {"use_gpu": None}


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module("." + name, __name__)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))


def init(use_gpu=None, trainer_count=1, **kwargs):
    """paddle.init: `use_gpu=False` runs the v2 API on the CPU; None or
    True on the card (checked when something first runs).
    `trainer_count`, log levels and the other reference flags are
    accepted and ignored, as in the JAX package: SGD trains on the one
    device `use_gpu` names whatever `trainer_count` says (data-parallel
    training is the trainer's, `run_config(trainer_count=)`)."""
    _settings["use_gpu"] = use_gpu


def place():
    """The fluid place `init` chose: CPUPlace() for use_gpu=False, else
    the card (CUDAPlace(0), which raises at first use without one)."""
    if _settings["use_gpu"] is False:
        return fluid.CPUPlace()
    return fluid.CUDAPlace(0)
