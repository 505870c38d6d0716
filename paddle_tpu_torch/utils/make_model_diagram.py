"""Generate a graphviz diagram of a legacy model config (reference
python/paddle/utils/make_model_diagram.py drew the ModelConfig layer
graph). Here the config executes to a fluid Program, and the existing
net drawer renders it."""

from __future__ import annotations

import sys

__all__ = ["make_diagram"]


def make_diagram(config_file, dot_file, config_arg_str=""):
    """Execute a trainer config (.py or .conf) and write its program
    graph as a .dot file."""
    from ..fluid.net_drawer import draw_graph
    from ..trainer import (
        _exec_config,
        _parse_config_args,
        resolve_config_outputs,
    )
    from ..v2.topology import Topology

    state = _exec_config(config_file, _parse_config_args(config_arg_str))
    topo = Topology(resolve_config_outputs(state))
    dot = draw_graph(topo.startup_program, topo.main_program)
    with open(dot_file, "w") as f:
        f.write(dot)
    return dot_file


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) < 2:
        sys.stderr.write(
            "usage: python -m paddle_tpu_torch.utils.make_model_diagram "
            "<config> <out.dot> [config_args]\n"
        )
        return 1
    make_diagram(argv[0], argv[1], argv[2] if len(argv) > 2 else "")
    return 0


if __name__ == "__main__":
    sys.exit(main())
