"""paddle.v2.data_feeder (reference python/paddle/v2/data_feeder.py,
wrapping py_paddle's DataProviderConverter): instance tuples -> the
executor's feed dict, slot order given by `feeding`."""

from __future__ import annotations

from .trainer import _convert_feed

__all__ = ["DataFeeder"]


class DataFeeder(object):
    def __init__(self, data_types, feeding=None):
        """data_types: [(name, data_type), ...] in provider slot order
        (the reference's constructor signature)."""
        from .layer import Layer

        self._nodes = []
        for name, t in data_types:
            node = Layer.__new__(Layer)
            node.kind = "data"
            node.name = name
            node.parents = []
            node.attrs = {"type": t}
            self._nodes.append(node)
        self._feeding = feeding

    def convert(self, dat, argument=None):
        return _convert_feed(dat, self._nodes, self._feeding)

    __call__ = convert
