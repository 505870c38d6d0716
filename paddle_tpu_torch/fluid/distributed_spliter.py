"""paddle.v2.fluid.distributed_spliter (reference distributed_spliter.py;
counterpart of paddle_tpu/fluid/distributed_spliter.py): assign
variables to parameter-server endpoints by name hash or round robin. The
transpiler runs on the mesh, but the assignment functions keep their
exact semantics for code that partitions by them."""

from __future__ import annotations

import hashlib

__all__ = ["hash_name", "round_robin"]


def hash_name(varlist, pserver_endpoints):
    """Stable name-hash assignment: a per-variable endpoint list."""
    def _hash_block(block_str, total):
        return int(hashlib.md5(block_str.encode()).hexdigest(), 16) % total

    return [pserver_endpoints[_hash_block(var.name, len(pserver_endpoints))]
            for var in varlist]


def round_robin(varlist, pserver_endpoints):
    """Cyclic assignment (reference round_robin)."""
    if len(varlist) <= len(pserver_endpoints):
        raise AssertionError(
            "round_robin expects more variables than endpoints")
    return [pserver_endpoints[i % len(pserver_endpoints)]
            for i in range(len(varlist))]
