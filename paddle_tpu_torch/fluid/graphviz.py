"""paddle.v2.fluid.graphviz (reference graphviz.py): dot-source
emission for program blocks; the implementation lives in debugger.py
(draw_block_graphviz)."""

from .debugger import draw_block_graphviz  # noqa: F401

__all__ = ["draw_block_graphviz"]
