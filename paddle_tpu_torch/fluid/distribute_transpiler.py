"""DistributeTranspiler: the reference's distributed-rewrite API mapped
onto mesh data parallelism (counterpart of
paddle_tpu/fluid/distribute_transpiler.py).

Reference (python/paddle/v2/fluid/distribute_transpiler.py:132): rewrites
the program into trainer programs (split + send gradient blocks) and
pserver programs (listen_and_serv + optimize blocks) wired over gRPC.
Here the whole mechanism collapses into the mesh executor: one process
per trainer (rank), each running the UNMODIFIED program over its shard
of the batch, and the executor sums the gradients over the ranks
(fluid/core/spmd.py). The API is kept so reference scripts run:

  t = fluid.DistributeTranspiler()
  t.transpile(trainer_id, pservers=..., trainers=N)
  exe.run(t.get_trainer_program(), ...)   # data-parallel over the mesh

`get_trainer_program` sets a default mesh {'data': trainers} over the
world (parallel.DistributedContext.initialize joins it first; torchrun or
explicit coordinates) when `trainers` > 1. `get_pserver_program` returns
an empty program: there is no pserver role, and running it is a no-op,
so pserver-branch scripts exit cleanly.

ASYNC SGD (reference ParameterServer2.h:127-139, go/pserver/
service.go:285): `Executor.run_async_local(steps, sync_every)` is its
local-SGD form (parallel/async_sgd.py). `transpile(sync_mode=False)`
records the request and warns which call to use; plain `exe.run` stays
synchronous.
"""

from __future__ import annotations

import warnings

from .core.program import Program, default_main_program

__all__ = ["DistributeTranspiler", "SimpleDistributeTranspiler",
           "memory_optimize"]


class DistributeTranspiler(object):
    def __init__(self):
        self._program = None
        self._trainers = 1

    def transpile(self, optimize_ops=None, params_grads=None, trainer_id=0,
                  program=None, pservers="127.0.0.1:6174", trainers=1,
                  split_method=None, sync_mode=True, **kwargs):
        """Accepts both reference calling conventions: the v0.11 form
        `transpile(optimize_ops, params_grads, pservers=..., trainers=N)`
        and the later `transpile(trainer_id[, program], pservers=...,
        trainers=N)`. `device` (a keyword of the port's) names this
        rank's device for the mesh; the card by default."""
        if isinstance(optimize_ops, int):
            trainer_id = optimize_ops
            if isinstance(params_grads, Program):
                program = params_grads
            elif params_grads is not None:
                raise TypeError(
                    "transpile(trainer_id, program, ...): program must be "
                    "a Program, got %r" % type(params_grads))
        # v0.11's (optimize_ops, params_grads) are accepted and unused:
        # SPMD needs no graph rewrite
        self._program = program or default_main_program()
        self._trainers = int(trainers)
        self._trainer_id = int(trainer_id)
        self._pservers = pservers.split(",") if isinstance(pservers, str) \
            else list(pservers)
        self._sync_mode = bool(sync_mode)
        self._device = kwargs.get("device")
        if not sync_mode:
            warnings.warn(
                "sync_mode=False (AsyncSGD) requested: use "
                "Executor.run_async_local(steps, sync_every), the "
                "local-SGD form of async DP (parallel/async_sgd.py); "
                "plain exe.run executes synchronously")

    def get_trainer_program(self) -> Program:
        """The original program, to be run by an Executor on a mesh whose
        'data' axis plays the role of `trainers`."""
        import torch.distributed as dist

        from ..parallel.mesh import (get_default_mesh, make_mesh,
                                     set_default_mesh)

        if not getattr(self, "_sync_mode", True):
            warnings.warn(
                "AsyncSGD was requested (sync_mode=False): exe.run on "
                "this program is synchronous; drive it with "
                "Executor.run_async_local(steps, sync_every) for the "
                "local-SGD async semantics")
        if get_default_mesh() is None:
            world = dist.get_world_size() if dist.is_initialized() else 1
            n = min(self._trainers, world)
            if n > 1:
                set_default_mesh(make_mesh({"data": n},
                                           device=self._device))
            elif self._trainers > 1:
                warnings.warn(
                    "transpile(trainers=%d) but the world has %d "
                    "process(es); running single-device with identical "
                    "global-batch math" % (self._trainers, world))
        return self._program

    def get_pserver_program(self, endpoint, *args, **kwargs) -> Program:
        return Program()  # no pserver role; the empty program is a no-op

    def get_startup_program(self, endpoint=None, pserver_program=None):
        return Program()


class SimpleDistributeTranspiler(DistributeTranspiler):
    """reference distribute_transpiler_simple.py: the same collapse."""


def memory_optimize(input_program, print_log=False, **kwargs):
    """reference memory_optimization_transpiler.py:270; delegates to the
    port's (memory_optimization_transpiler.memory_optimize)."""
    from .memory_optimization_transpiler import memory_optimize as _mo

    return _mo(input_program, print_log=print_log, **kwargs)
