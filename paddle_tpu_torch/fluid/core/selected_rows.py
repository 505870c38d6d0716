"""SelectedRows: the sparse-gradient value for embedding tables
(counterpart of paddle_tpu/fluid/core/selected_rows.py).

Reference parity: paddle/fluid/framework/selected_rows.h (rows + value
block + height), the SelectedRows branches of the optimizer ops
(operators/sgd_op.cc, adam_op.h) and math/selected_rows_functor.cc
(MergeAdd).

A SelectedRows is a pair of device tensors (`rows` int64 [n], `values`
[n, dim]) with the table's `height` (its vocabulary size). `n` is the
number of lookup sites in the batch, so every operation here keeps that
static length: a sort, a cumsum, index_add_ and scatter_, none of which
reads the device from the host. No dense [height, dim] gradient exists
on this path. A row equal to `height` is a sentinel (padding_idx
positions, merge leftovers): it contributes nothing. Torch has no
"drop" mode for out-of-range indices (on CUDA one is a device-side
assert), so each consumer aims a sentinel at a real row with a value
that leaves it unchanged (`to_dense`, and the optimizer kernels in
kernels_optim.py).
"""

from __future__ import annotations

import torch

__all__ = ["SelectedRows", "as_dense"]


class SelectedRows:
    """Sparse gradient: `values[i]` is the gradient contribution to row
    `rows[i]` of a [height, dim] parameter. Rows may repeat (one entry
    per lookup occurrence); duplicates SUM, matching the dense gradient.
    """

    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height: int):
        self.rows = rows
        self.values = values
        self.height = int(height)

    def astype(self, dtype):
        return SelectedRows(self.rows, self.values.to(dtype), self.height)

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self):
        """Densify: scatter-add the contributions into a zero [height,
        dim] tensor (duplicates merge by addition; a sentinel adds 0.0
        to row 0, which is exact)."""
        out = torch.zeros((self.height,) + tuple(self.values.shape[1:]),
                          dtype=self.values.dtype,
                          device=self.values.device)
        valid = self.rows < self.height
        vals = torch.where(_col(valid, self.values), self.values,
                           torch.zeros_like(self.values))
        return out.index_add_(0, torch.where(valid, self.rows, 0), vals)

    def merged(self):
        """Combine duplicate rows (reference MergeAdd,
        math/selected_rows_functor.cc): returns (rows', values') of the
        SAME length where each row appears at most once with its
        contributions summed, in ascending row order; surplus slots carry
        the sentinel `height` and zero values. The moment-tracking
        optimizers need it: their per-row state update must fire once
        per touched row, not once per occurrence. Sentinel inputs sort
        last and merge into one sentinel slot."""
        n = self.rows.shape[0]
        r, order = torch.sort(self.rows, stable=True)
        v = self.values.index_select(0, order)
        is_new = torch.ones(n, dtype=torch.int64, device=r.device)
        is_new[1:] = (r[1:] != r[:-1]).to(torch.int64)
        seg = torch.cumsum(is_new, 0) - 1
        merged_v = torch.zeros_like(v).index_add_(0, seg, v)
        # every element of a segment writes the same row id, so the
        # duplicate-index scatter is deterministic
        merged_r = torch.full((n,), self.height, dtype=r.dtype,
                              device=r.device).scatter_(0, seg, r)
        return merged_r, merged_v


def _col(mask, like):
    """`mask` [n] viewed to broadcast over the trailing dims of `like`."""
    return mask.view((-1,) + (1,) * (like.dim() - 1))


def as_dense(x):
    """Densify if `x` is a SelectedRows, else pass through. Fetches and
    sparse-unaware consumers use this, so a sparse gradient is always
    observable as its dense equivalent."""
    return x.to_dense() if isinstance(x, SelectedRows) else x
