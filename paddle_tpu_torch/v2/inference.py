"""paddle.v2.inference (counterpart of paddle_tpu/v2/inference.py;
reference python/paddle/v2/inference.py), on the device `paddle.init`
chose:
the Inference class binds a network output + trained Parameters once and
serves repeated infer() calls; the module-level infer() is the one-shot
form (re-exported as paddle.v2.infer)."""

from __future__ import annotations

from . import minibatch
from .topology import Topology
from .trainer import _convert_feed
from .. import fluid

__all__ = ["infer", "Inference"]


def infer(output_layer, parameters, input, feeding=None, field="value"):
    """paddle.infer (reference inference.py:125): one-shot form over the
    Inference class — single binding path for parameter loading."""
    return Inference(output_layer, parameters).infer(input,
                                                     feeding=feeding,
                                                     field=field)


class Inference(object):
    """Bind (output_layer, parameters) once; iterate batches with
    iter_infer_field / run one batch with infer (reference
    inference.py:24)."""

    def __init__(self, output_layer, parameters):
        outputs = output_layer if isinstance(output_layer, (list, tuple)) \
            else [output_layer]
        self._outputs = list(outputs)
        self._topo = Topology(self._outputs)
        from . import place

        self._exe = fluid.Executor(place())
        self._scope = fluid.executor.Scope()
        with fluid.executor.scope_guard(self._scope):
            self._exe.run(self._topo.startup_program)
            for v in self._topo.main_program.list_vars():
                if v.persistable and parameters.has_key(v.name):
                    self._scope.set(v.name, parameters[v.name])

    def infer(self, input, feeding=None, field="value"):
        if field not in ("value",):
            raise NotImplementedError(
                "field=%r: this core returns layer VALUES; ids come from "
                "max_id/beam layers in the graph itself" % (field,)
            )
        feed = _convert_feed(input, self._topo._data_layers, feeding)
        with fluid.executor.scope_guard(self._scope):
            fetches = self._exe.run(
                self._topo.main_program, feed=feed,
                fetch_list=[self._topo.var_of[o.name]
                            for o in self._outputs],
            )
        return fetches[0] if len(fetches) == 1 else fetches

    def iter_infer(self, input, feeding=None, batch_size=128):
        for batch in minibatch.batch(lambda: iter(input), batch_size)():
            yield self.infer(batch, feeding=feeding)

    def iter_infer_field(self, input, field="value", feeding=None,
                         batch_size=128):
        """Reference inference.py iter_infer_field: per-batch results of
        one field."""
        for batch in minibatch.batch(lambda: iter(input), batch_size)():
            yield self.infer(batch, feeding=feeding, field=field)
