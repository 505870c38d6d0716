"""Row-sharded embedding tables (counterpart of
paddle_tpu/parallel/embedding.py).

Replaces the reference's row-sharded sparse parameter server
(SparseRemoteParameterUpdater, the prefetch of needed rows in
MultiGradientMachine.h:140-166, fluid SelectedRows + split/sum ops): the
table lives split along its rows over a mesh axis, each rank holding one
block of V/n rows. A lookup is a local gather of the ids in this rank's
range (zero rows for the others) and one sum over the axis, since each
id's row lives on exactly one rank; the backward is the transpose, a
scatter-add of exactly the rows this rank owns. An id outside [0, V)
reads a zero row on every rank.

The Fluid `lookup_table` of a table with a row spec over an axis takes
the same path (fluid/core/kernels_tensor.py `_sharded_lookup`), and its
SelectedRows update touches only this rank's rows.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import collectives
from .mesh import Mesh, get_default_mesh

__all__ = ["sharded_lookup", "ShardedEmbedding", "local_rows"]


def local_rows(flat_ids, rows_here: int, index: int):
    """(local row of each id, clamped into range; whether this rank owns
    it) for a rank holding rows [index * rows_here, (index + 1) *
    rows_here) of the table."""
    local = flat_ids - index * rows_here
    owned = (local >= 0) & (local < rows_here)
    return torch.where(owned, local, torch.zeros_like(local)), owned


def sharded_lookup(table, ids, mesh: Optional[Mesh] = None,
                   axis: str = "model"):
    """`table` is this rank's block [V/n, D] of a [V, D] table split along
    its rows over `axis` (the whole table where the mesh has no such axis
    or it has extent 1); `ids` any int tensor. Returns ids.shape + [D],
    differentiable (the backward adds into this rank's rows only)."""
    mesh = mesh if mesh is not None else get_default_mesh()
    flat = ids.reshape(-1).long()
    if mesh is None or axis not in mesh.axis_names or \
            mesh.shape[axis] == 1:
        local, owned = local_rows(flat, table.shape[0], 0)
        group = None
    else:
        local, owned = local_rows(flat, table.shape[0], mesh.index(axis))
        group = mesh.group(axis)
    rows = table[local]
    rows = torch.where(owned[:, None], rows, torch.zeros_like(rows))
    out = collectives.all_reduce_autograd(rows, group)
    return out.reshape(tuple(ids.shape) + (table.shape[1],))


class ShardedEmbedding(object):
    """Owner of a row-sharded table: draws the whole [vocab, dim] table
    from `seed` (normal * scale, the same on every rank) and keeps this
    rank's block of rows on the mesh's device."""

    def __init__(self, vocab: int, dim: int, mesh: Mesh,
                 axis: str = "model", dtype=torch.float32,
                 scale: float = 0.01, seed: int = 0):
        self.mesh = mesh
        self.axis = axis
        n = mesh.shape[axis] if axis in mesh.axis_names else 1
        if vocab % n:
            raise ValueError("vocab %d not divisible by mesh axis %r size %d"
                             % (vocab, axis, n))
        gen = torch.Generator().manual_seed(int(seed))
        full = scale * torch.randn((vocab, dim), generator=gen)
        i = mesh.index(axis) if n > 1 else 0
        rows = vocab // n
        self.table = full[i * rows:(i + 1) * rows].to(
            device=mesh.device, dtype=dtype).requires_grad_(True)

    def __call__(self, ids):
        return sharded_lookup(self.table, ids, self.mesh, self.axis)
