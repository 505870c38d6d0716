"""Dump a v2 network topology to a file (reference
python/paddle/utils/dump_v2_config.py). The reference wrote the
ModelConfig protobuf (text or serialized) for the C-API; here the
language-neutral wire format is the JSON program schema
(fluid/core/serialization.py), which the native C++ inference runner
(`native/inference.cc`) consumes — `binary=True` writes it gzip-compressed."""

from __future__ import annotations

import gzip

__all__ = ["dump_v2_config"]


def dump_v2_config(topology, save_path, binary=False):
    """Dump the network reachable from `topology`'s output layers.

    topology: LayerOutput, list/tuple of them, or a v2 Topology.
    save_path: destination file.
    binary: gzip the JSON (the compact form the serving path ships).
    """
    from ..fluid.core.serialization import dumps_program
    from ..v2.topology import Topology

    if not isinstance(topology, Topology):
        topology = Topology(topology)
    payload = dumps_program(topology.main_program, indent=None if binary else 2)
    if binary:
        with gzip.open(save_path, "wb") as f:
            f.write(payload.encode("utf-8"))
    else:
        with open(save_path, "w") as f:
            f.write(payload)
