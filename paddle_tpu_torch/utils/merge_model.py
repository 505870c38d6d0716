"""Merge a v2 net config + trained parameters into a deployable
inference bundle (counterpart of paddle_tpu/utils/merge_model.py;
reference python/paddle/utils/merge_model.py merge_v2_model, which
packed ModelConfig proto + tar'd params for the capi runner).

The bundle is the JSON program + npy parameters directory that both
`fluid.io.load_inference_model` and the dependency-free C++ runner
(`native.InferenceRunner`, `native/inference.cc`) consume, in either
package.

Usage:
    from paddle_tpu_torch.utils.merge_model import merge_v2_model
    net = paddle.layer.fc(...)               # a v2/DSL layer node
    merge_v2_model(net, "trained.tar", "./deploy_model")

It runs the net's startup program on the CPU, whatever `paddle.init`
chose: the startup only lays out a scope for the tar's values, and the
bundle is files. Nothing of it runs on the card.
"""

from __future__ import annotations

__all__ = ["merge_v2_model"]


def merge_v2_model(net, param_file, output_dir):
    """net: the network's output layer node; param_file: a Parameters
    tar (v2 wire format) path or file object; output_dir: bundle
    directory (created). Raises ValueError when the tar does not hold
    every persistable of the net."""
    from .. import fluid
    from ..v2.parameters import Parameters
    from ..v2.topology import Topology

    topo = Topology([net])
    if hasattr(param_file, "read"):
        loaded = Parameters.from_tar(param_file)
    else:
        with open(param_file, "rb") as f:
            loaded = Parameters.from_tar(f)

    scope = fluid.executor.Scope()
    with fluid.executor.scope_guard(scope):
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(topo.startup_program)
        # every persistable (parameters AND batch-norm moving stats —
        # Parameters.to_tar writes both) must come from the tar
        net_persist = {
            v.name
            for v in topo.main_program.list_vars()
            if v.persistable
        }
        tar_names = set(loaded.names())
        missing = sorted(net_persist - tar_names)
        if missing:
            raise ValueError(
                "parameter tar does not cover the net: missing %r "
                "(tar has %r) — a bundle with random weights would be "
                "silently wrong" % (missing, sorted(tar_names))
            )
        for name in tar_names & net_persist:
            scope.set(name, loaded.get(name))
        out_var = topo.var_of[net.name]
        feed_names = [n.name for n in topo._data_layers]
        fluid.io.save_inference_model(
            output_dir, feed_names, [out_var], exe,
            main_program=topo.main_program,
        )
    return output_dir
