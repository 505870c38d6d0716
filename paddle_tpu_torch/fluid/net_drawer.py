"""paddle.v2.fluid.net_drawer (reference net_drawer.py): draw a
program's dataflow as graphviz dot."""

from .debugger import draw_block_graphviz

__all__ = ["draw_graph"]


def draw_graph(startup_program, main_program, path=None, name="network"):
    """Dot source of the main program's global block (the reference CLI
    drew ops+vars; startup is accepted for signature parity)."""
    return draw_block_graphviz(
        main_program.global_block(), path=path, name=name
    )
