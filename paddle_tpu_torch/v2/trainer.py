"""paddle.v2.trainer.SGD: the v2 train/test loop over the fluid executor
(counterpart of paddle_tpu/v2/trainer.py; reference
python/paddle/v2/trainer.py:37 SGD, :137 train — there it drives the
SWIG GradientMachine + ParameterUpdater; here one Executor run per batch
on the device of the trainer's Parameters)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .. import fluid
from . import event as v2_event
from . import data_type as dt
from .parameters import Parameters
from .topology import Topology

__all__ = ["SGD"]


def _convert_feed(batch, data_nodes, feeding):
    """Batch of instance tuples -> fluid feed dict, per data-layer type
    (the py_paddle DataProviderConverter's job in the reference)."""
    names = [n.name for n in data_nodes]
    if feeding is None:
        feeding = {name: i for i, name in enumerate(names)}
    feed = {}
    for node in data_nodes:
        idx = feeding[node.name]
        col = [inst[idx] for inst in batch]
        t = node.attrs["type"]
        if t.seq_type == 0:  # plain
            if t.type == dt.DataType.Index:
                feed[node.name] = np.asarray(col, np.int64).reshape(-1, 1)
            elif t.type in (dt.DataType.SparseNonValue, dt.DataType.SparseValue):
                # sparse instances materialise to dense rows (the
                # executor's feeds are dense; reference converts via
                # SparseBinaryScanner)
                dense = np.zeros((len(col), t.dim), np.float32)
                for r, inst in enumerate(col):
                    if t.type == dt.DataType.SparseNonValue:
                        dense[r, list(inst)] = 1.0
                    else:
                        for i, v in inst:
                            dense[r, int(i)] = float(v)
                feed[node.name] = dense
            else:
                feed[node.name] = np.asarray(col, np.float32).reshape(
                    len(col), -1
                )
        else:  # single-level sequence -> packed + offsets
            lens = [len(x) for x in col]
            lod = np.cumsum([0] + lens).astype(np.int32)
            if t.type == dt.DataType.Index:
                flat = np.concatenate(
                    [np.asarray(x, np.int64).reshape(-1) for x in col]
                ).reshape(-1, 1)
            else:
                flat = np.concatenate(
                    [np.asarray(x, np.float32).reshape(len(x), -1) for x in col]
                )
            feed[node.name] = (flat, [lod])
    return feed


def _metric_value(m):
    """Scalars become floats; vector metrics (column_sum) stay arrays."""
    arr = np.ravel(np.asarray(m))
    return float(arr[0]) if arr.size == 1 else np.asarray(m)


class SGD(object):
    def __init__(self, cost, parameters, update_equation, extra_layers=None,
                 is_local=True, pserver_spec=None, use_etcd=True):
        if not isinstance(parameters, Parameters):
            raise TypeError("parameters should be paddle.v2.parameters.create(...)")
        self.__parameters__ = parameters
        # reuse the parameters' topology when it covers this cost, so the
        # trainer updates the same scope arrays in place
        topo = parameters.topology
        if not any(l is cost for l in topo.output_layers) or any(
            l.name not in topo.var_of for l in (extra_layers or [])
        ):
            topo = Topology([cost], extra_layers=extra_layers)
        # a topology can host at most one optimizer: a second SGD over the
        # same Parameters gets a fresh replay of the DAG instead of
        # appending a second backward pass to the shared program
        if getattr(topo, "_minimized", False):
            topo = Topology([cost], extra_layers=extra_layers)
        self._topology = topo
        self._cost_var = topo.var_of[cost.name]
        # metric layers from extra_layers: fetched every batch and handed
        # to event handlers via the evaluator payload (reference book
        # handlers read event.evaluator after each iteration)
        metric_layers = [
            l for l in getattr(topo, "extra_layers", [])
            if l.name in topo.var_of
        ]
        self._metric_fetches = [
            (l.name, topo.var_of[l.name]) for l in metric_layers
        ]
        # accumulation semantics per metric: sum-type evaluators report a
        # running TOTAL over the dataset (reference sum_evaluator /
        # column_sum_evaluator), ratio metrics an example-weighted mean
        self._metric_is_sum = [
            getattr(l, "kind", "") in ("sum_evaluator", "column_sum_evaluator")
            for l in metric_layers
        ]
        # snapshot the forward-only program BEFORE minimize appends the
        # backward+update ops: test() must never touch parameters
        self._test_program = topo.main_program.clone(for_test=True)
        self._optimizer = update_equation._fluid()
        self._model_average = None
        with fluid.program_guard(topo.main_program, topo.startup_program):
            self._optimizer.minimize(self._cost_var)
            # legacy update_hooks: params with a pruning hook get their
            # static mask built + re-applied after every update — BEFORE
            # ModelAverage so the EMA accumulates masked (sparse) values
            self._pruning = fluid.optimizer.StaticPruning().build(
                topo.main_program, topo.startup_program
            )
            ma_spec = getattr(update_equation, "model_average", None)
            if ma_spec is not None:
                # reference averaged parameters (trainer.py:130 catchUp/
                # apply/restore): EMA slots inside the train step; test()
                # and save_parameter_to_tar run on the averages
                self._model_average = fluid.optimizer.ModelAverage.from_spec(
                    ma_spec
                ).build(topo.main_program)
        topo._minimized = True
        # initialize ONLY vars not already in the parameters' scope (the
        # optimizer state); re-running the full startup program would
        # clobber values loaded via Parameters.init_from_tar
        from . import place

        self._exe = fluid.Executor(place())
        startup = topo.startup_program.clone()
        blk = startup.global_block()
        blk.ops = [
            op
            for op in blk.ops
            if any(n not in parameters.scope for n in op.output_arg_names)
        ]
        with fluid.executor.scope_guard(parameters.scope):
            self._exe.run(startup)
        # params that were initialized BEFORE this trainer existed (the
        # Parameters.create startup) bypassed the in-startup mask apply:
        # sparsify them now so pruning holds from step 0
        for pname, mname in self._pruning.masks.items():
            sc = parameters.scope
            if pname in sc and mname in sc:
                sc.set(pname, fluid.executor.as_numpy(sc.get(pname))
                       * fluid.executor.as_numpy(sc.get(mname)))

    # ------------------------------------------------------------------
    def train(self, reader, num_passes=1, event_handler=None, feeding=None):
        if event_handler is None:
            event_handler = lambda e: None
        data_nodes = self._topology._data_layers
        scope = self.__parameters__.scope
        from ..fluid.data_feeder import AsyncDeviceFeeder

        for pass_id in range(num_passes):
            event_handler(v2_event.BeginPass(pass_id))

            def _feeds():
                # decode + upload in a background thread: batch k+1
                # overlaps the device step on batch k (reference
                # DataProvider.h:249 DoubleBuffer)
                for batch in reader():
                    yield _convert_feed(batch, data_nodes, feeding)

            from ..parallel.mesh import get_default_mesh, spans_processes

            _mesh = self._exe.mesh or get_default_mesh()
            feeder = AsyncDeviceFeeder(
                _feeds(), capacity=2,
                upload=not (_mesh is not None and spans_processes(_mesh)),
                place=self._exe.place,
            )
            try:
                self._train_pass(
                    feeder, pass_id, event_handler, scope)
            finally:
                feeder.close()
            event_handler(v2_event.EndPass(pass_id))

    def _train_pass(self, feeds, pass_id, event_handler, scope):
        for batch_id, feed in enumerate(feeds):
            event_handler(v2_event.BeginIteration(pass_id, batch_id))
            with fluid.executor.scope_guard(scope):
                fetched = self._exe.run(
                    self._topology.main_program,
                    feed=feed,
                    fetch_list=[self._cost_var]
                    + [v for _, v in self._metric_fetches],
                )
            cost, metrics = fetched[0], fetched[1:]
            event_handler(
                v2_event.EndIteration(
                    pass_id, batch_id, float(np.ravel(cost)[0]),
                    evaluator=self._metric_payload(metrics),
                )
            )

    # ------------------------------------------------------------------
    def _avg_apply_ctx(self):
        """Averaged-parameter context for eval/export: the EMA weights
        when averaging is configured AND at least one step has trained;
        the live weights otherwise (e.g. evaluating a freshly-loaded
        model before train())."""
        import contextlib

        ma = self._model_average
        if ma is None:
            return contextlib.nullcontext()
        scope = self.__parameters__.scope
        steps = scope.get(ma._steps_name) if ma._steps_name in scope else None
        if steps is None or float(
                np.ravel(fluid.executor.as_numpy(steps))[0]) < 1.0:
            return contextlib.nullcontext()
        return ma.apply(scope=scope)

    def test(self, reader, feeding=None):
        data_nodes = self._topology._data_layers
        scope = self.__parameters__.scope
        # averaged parameters evaluate the EMA weights (reference: the
        # tester's apply/restore around averaged params)
        avg_ctx = self._avg_apply_ctx()
        test_prog = self._test_program  # forward-only snapshot, stable id
        # the test program is a pre-minimize clone: metric vars live in it
        # under the same names
        metric_vars = [
            test_prog.global_block().var(v.name)
            for _, v in self._metric_fetches
        ]
        with avg_ctx:
            costs, n = [], 0
            metric_sums = [0.0] * len(metric_vars)
            for batch in reader():
                feed = _convert_feed(batch, data_nodes, feeding)
                with fluid.executor.scope_guard(scope):
                    fetched = self._exe.run(
                        test_prog, feed=feed,
                        fetch_list=[test_prog.global_block().var(
                            self._cost_var.name)] + metric_vars,
                    )
                costs.append(float(np.ravel(fetched[0])[0]) * len(batch))
                for i, m in enumerate(fetched[1:]):
                    # sum evaluators accumulate a dataset TOTAL; ratio metrics
                    # (classification_error, auc) average example-weighted
                    v = np.asarray(_metric_value(m))
                    if self._metric_is_sum[i]:
                        metric_sums[i] = metric_sums[i] + v
                    else:
                        metric_sums[i] = metric_sums[i] + v * len(batch)
                n += len(batch)
            avg = sum(costs) / max(n, 1)
            evaluator = {}
            for i, (name, _) in enumerate(self._metric_fetches):
                val = np.asarray(metric_sums[i])
                if not self._metric_is_sum[i]:
                    val = val / max(n, 1)
                evaluator[name] = float(val) if val.ndim == 0 else val
            return v2_event.TestResult(evaluator=evaluator, cost=avg)

    def _metric_payload(self, metrics):
        return {
            name: _metric_value(m)
            for (name, _), m in zip(self._metric_fetches, metrics)
        }

    def save_parameter_to_tar(self, f):
        # export averaged weights when averaging is active (reference
        # save with averaged params applied); live weights otherwise
        with self._avg_apply_ctx():
            self.__parameters__.to_tar(f)


def infer(output_layer, parameters, input, feeding=None):
    """paddle.infer (reference python/paddle/v2/inference.py): forward
    the prediction sub-graph with the given parameters. Delegates to
    inference.Inference — one binding path."""
    from .inference import Inference

    return Inference(output_layer, parameters).infer(input,
                                                     feeding=feeding)
