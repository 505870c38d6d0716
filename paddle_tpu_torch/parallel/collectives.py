"""Collectives over a mesh axis's process group: the port's stand-in for
the psum / all-gather / reduce-scatter that XLA's SPMD partitioner
inserts in the JAX package (paddle_tpu/parallel/mesh.py, executor.py).

Every operation here is expressed through ONE collective, the sum
all-reduce of `torch.distributed._functional_collectives`, the same way
on every backend: gloo has no all-gather or reduce-scatter for CUDA
tensors (the card's two-ranks-on-one-card test runs gloo there), and one
code path keeps the numbers of every backend alike.

- all_gather(x, dim): this rank's block placed in a zero tensor of the
  full extent, then summed (exact: every element has one non-zero term);
- reduce_scatter(x, dim): the sum, then this rank's block.

The cost: an all-gather or reduce-scatter moves n times the bytes of its
native form; on a card with many peers that is later work (ROADMAP).

The differentiable forms are one autograd function, `_AllReduce`, whose
backward is the sum all-reduce of the upstream gradients (the exact
adjoint of a sum whose result every rank holds); all_gather's backward is
then reduce-scatter and reduce-scatter's all-gather. The executor seeds
the backward of a loss every rank holds with 1 / (ranks) (core/spmd.py),
which makes every gradient the exact global-batch gradient.

`sync_gradients` all-reduces a step's gradients in a few flat buckets of
at most BUCKET_BYTES, not one call per parameter, and counts its calls,
buckets and bytes in the caller's `SyncStats` (each mesh has one), which
with `timed` set also keeps a pair of CUDA events around each sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed._functional_collectives as funcol

__all__ = ["all_reduce", "all_reduce_autograd", "all_gather",
           "reduce_scatter", "sync_gradients", "SyncStats", "BUCKET_BYTES"]

# DDP's default bucket: ResNet-50's 102 MB of f32 gradients in 5 calls
BUCKET_BYTES = 25 * 1024 * 1024


class SyncStats(object):
    """Counts of the gradient syncs (calls, buckets, bytes); with `timed`
    set, (start, end) CUDA events around each sync in `events`."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = self.buckets = self.bytes = 0
        self.events: List[tuple] = []

    def device_ms(self) -> float:
        """The device time of the recorded syncs (synchronizes)."""
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of `x` over `group` as a new tensor (no autograd);
    `x` itself where the group is this rank alone (None). A bool tensor
    travels as uint8 (NCCL has no bool sum)."""
    if group is None:
        return x
    if x.dtype == torch.bool:
        return all_reduce(x.to(torch.uint8), group, op).bool()
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def all_reduce_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over `group`, differentiable (backward: the sum of
    the upstream gradients)."""
    if group is None:
        return x
    if not (x.requires_grad and torch.is_grad_enabled()):
        return all_reduce(x, group)
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group, index: int, n: int
               ) -> torch.Tensor:
    """The n blocks of `group` concatenated along `dim` in group order,
    this rank's block `x` at `index`; differentiable (backward:
    reduce-scatter)."""
    if group is None or n == 1:
        return x
    zero = torch.zeros_like(x)
    parts = [x if i == index else zero for i in range(n)]
    return all_reduce_autograd(torch.cat(parts, dim), group)


def reduce_scatter(x: torch.Tensor, dim: int, group, index: int, n: int
                   ) -> torch.Tensor:
    """Block `index` (of n along `dim`) of the sum of `x` over `group`;
    differentiable (backward: all-gather)."""
    if group is None or n == 1:
        return x
    size = x.shape[dim] // n
    return all_reduce_autograd(x, group).narrow(dim, index * size, size)


def sync_gradients(grads: Dict[str, torch.Tensor], group,
                   stats: Optional[SyncStats] = None,
                   bucket_bytes: int = BUCKET_BYTES
                   ) -> Dict[str, torch.Tensor]:
    """Sum each gradient over `group`, flattened into buckets of one dtype
    and at most `bucket_bytes` (a gradient larger than that is a bucket
    alone). Returns {name: summed gradient}, views into the buckets."""
    if group is None or not grads:
        return dict(grads)
    stats = stats if stats is not None else SyncStats()
    timed = stats.timed and any(g.is_cuda for g in grads.values())
    if timed:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    buckets: List[list] = []
    open_by_dtype: Dict[torch.dtype, list] = {}
    for name, g in grads.items():
        b = open_by_dtype.get(g.dtype)
        nbytes = g.numel() * g.element_size()
        if b is None or (b[1] and b[1] + nbytes > bucket_bytes):
            b = [[], 0]
            open_by_dtype[g.dtype] = b
            buckets.append(b)
        b[0].append(name)
        b[1] += nbytes
    out = {}
    for names, nbytes in buckets:
        flat = torch.cat([grads[n].reshape(-1) for n in names])
        flat = all_reduce(flat, group)
        off = 0
        for n in names:
            k = grads[n].numel()
            out[n] = flat[off:off + k].view(grads[n].shape)
            off += k
        stats.buckets += 1
        stats.bytes += nbytes
    stats.calls += 1
    if timed:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        stats.events.append((start, end))
    return out
