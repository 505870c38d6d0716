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
- reduce_scatter(x, dim): the sum, then this rank's block;
- all_to_all(x, split_dim, concat_dim): every rank's n blocks placed in
  one zero [n, n, ...] tensor at its row, summed, and column `index`
  read back (lax.all_to_all with tiled=True);
- shift(x): this rank's tensor placed at its row of a zero [n, ...]
  tensor, summed, and the row of the previous rank read back
  (lax.ppermute with the ring [(i, (i + 1) % n)]); rotations(x), the
  n - 1 successive shifts of a ring as one autograd node.

The cost: each of them moves n times the bytes of its native form; on a
card with many peers that is later work (ROADMAP).

The differentiable forms are one autograd function, `_AllReduce`, whose
backward is the sum all-reduce of the upstream gradients (the exact
adjoint of a sum whose result every rank holds); all_gather's backward is
then reduce-scatter and reduce-scatter's all-gather. all_to_all,
shift and rotations are autograd functions of their own whose backward
is the exact adjoint: the inverse exchange, the reverse shift(s).

A rank's backward runs the collectives of the autograd nodes it
reaches, in the engine's order, and the ranks' collectives pair up only
if every rank builds the same graph of them: the mesh bodies therefore
keep one graph on every rank (a data- or rank-dependent branch never
leaves a collective's output unused on some ranks only). The executor seeds
the backward of a loss every rank holds with 1 / (ranks) (core/spmd.py),
which makes every gradient the exact global-batch gradient.

`sync_gradients` all-reduces a step's gradients in a few flat buckets of
at most BUCKET_BYTES, not one call per parameter, and counts its calls,
buckets and bytes in the caller's `SyncStats` (each mesh has one), which
with `timed` set also keeps a pair of CUDA events around each sync.
`MeshAxis` is one named axis of a mesh seen from this rank (its group,
index and extent): the port's stand-in for an axis name inside
shard_map, which the sequence-parallel, MoE and pipeline bodies take;
their exchanges count in its `SyncStats` too.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.distributed._functional_collectives as funcol

__all__ = ["all_reduce", "all_reduce_autograd", "all_gather",
           "reduce_scatter", "all_to_all", "shift", "rotations",
           "MeshAxis",
           "sync_gradients", "SyncStats", "BUCKET_BYTES"]

# DDP's default bucket: ResNet-50's 102 MB of f32 gradients in 5 calls
BUCKET_BYTES = 25 * 1024 * 1024


class SyncStats(object):
    """Counts of the gradient syncs (calls, buckets, bytes), of the
    all_to_all / shift exchanges, forward and backward (`exchanges`,
    `exchange_bytes`: the bytes each all-reduce moved), and of the
    tokens of this rank that the expert-parallel MoE dropped
    (`dropped_tokens`: 0, or a device tensor summed without a host
    read); with `timed` set, (start, end) CUDA events around each sync
    in `events`."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self):
        self.calls = self.buckets = self.bytes = 0
        self.exchanges = self.exchange_bytes = 0
        self.dropped_tokens = 0
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


def _count(stats, t):
    if stats is not None:
        stats.exchanges += 1
        stats.exchange_bytes += t.numel() * t.element_size()


def _exchange(x, split_dim, concat_dim, group, index, n, stats):
    chunks = torch.stack(x.chunk(n, split_dim))  # [n, ...]: block j -> j
    buf = x.new_zeros((n,) + tuple(chunks.shape))
    buf[index] = chunks
    _count(stats, buf)
    buf = all_reduce(buf, group)
    return torch.cat(buf[:, index].unbind(0), concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group, index, n, stats):
        ctx.args = (split_dim, concat_dim, group, index, n, stats)
        return _exchange(x, split_dim, concat_dim, group, index, n, stats)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, group, index, n, stats = ctx.args
        return (_exchange(g, concat_dim, split_dim, group, index, n, stats),
                None, None, None, None, None, None)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group,
               index: int, n: int, stats: Optional[SyncStats] = None
               ) -> torch.Tensor:
    """lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True): `x` splits into n blocks along `split_dim`, block j
    goes to the rank at index j of `group`, and the n blocks received
    are concatenated along `concat_dim` in group order. On [n, ...]
    with both dims 0 it is also tiled=False on that leading axis.
    Differentiable (backward: the inverse exchange)."""
    if group is None or n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError("all_to_all: dim %d of %s does not split over %d "
                         "ranks" % (split_dim, tuple(x.shape), n))
    if x.requires_grad and torch.is_grad_enabled():
        return _AllToAll.apply(x, split_dim, concat_dim, group, index, n,
                               stats)
    return _exchange(x, split_dim, concat_dim, group, index, n, stats)


def _shifted(x, offset, group, index, n, stats):
    buf = x.new_zeros((n,) + tuple(x.shape))
    buf[index] = x
    _count(stats, buf)
    return all_reduce(buf, group)[(index - offset) % n]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offset, group, index, n, stats):
        ctx.args = (offset, group, index, n, stats)
        return _shifted(x, offset, group, index, n, stats)

    @staticmethod
    def backward(ctx, g):
        offset, group, index, n, stats = ctx.args
        return (_shifted(g, -offset, group, index, n, stats),
                None, None, None, None, None)


def shift(x: torch.Tensor, group, index: int, n: int, offset: int = 1,
          stats: Optional[SyncStats] = None) -> torch.Tensor:
    """lax.ppermute(x, perm=[(i, (i + offset) % n)]): every rank sends
    `x` `offset` places on round the ring of `group` and returns what
    the rank `offset` places before it sent. Differentiable (backward:
    the reverse shift)."""
    if group is None or n == 1:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _Shift.apply(x, offset, group, index, n, stats)
    return _shifted(x, offset, group, index, n, stats)


def _rotate(x, group, index, n, stats):
    out = [x]
    for _ in range(n - 1):
        out.append(_shifted(out[-1], 1, group, index, n, stats))
    return torch.stack(out)


class _Rotations(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n, stats):
        ctx.args = (group, index, n, stats)
        return _rotate(x, group, index, n, stats)

    @staticmethod
    def backward(ctx, g):
        group, index, n, stats = ctx.args
        acc = g[n - 1]
        for i in range(n - 1, 0, -1):
            acc = _shifted(acc, -1, group, index, n, stats) + g[i - 1]
        return acc, None, None, None, None


def rotations(x: torch.Tensor, group, index: int, n: int,
              stats: Optional[SyncStats] = None) -> torch.Tensor:
    """[n, *x.shape]: entry i is the `x` of the rank i places before
    this one round the ring of `group` (entry 0 this rank's own), after
    i successive shifts. One autograd node for all of them (backward:
    the n - 1 reverse shifts, accumulated), so every rank runs the same
    collectives in its backward even where it leaves some entries
    unused (a causal ring skipping fully masked blocks)."""
    if group is None or n == 1:
        return x[None]
    if x.requires_grad and torch.is_grad_enabled():
        return _Rotations.apply(x, group, index, n, stats)
    return _rotate(x, group, index, n, stats)


class MeshAxis(object):
    """One named axis of a mesh as this rank sees it: the process group
    of the ranks that share its other coordinates (`group`, None when
    the axis has extent 1), this rank's `index` along it, its extent
    `n`, and the `stats` its exchanges count in. The mesh bodies take
    it where the JAX package's take an axis name inside shard_map."""

    def __init__(self, group, index: int, n: int,
                 stats: Optional[SyncStats] = None):
        self.group, self.index, self.n = group, int(index), int(n)
        self.stats = stats

    @classmethod
    def of(cls, mesh, name: str) -> "MeshAxis":
        return cls(mesh.group(name), mesh.index(name), mesh.extent(name),
                   mesh.sync_stats)

    def all_to_all(self, x, split_dim, concat_dim):
        return all_to_all(x, split_dim, concat_dim, self.group, self.index,
                          self.n, self.stats)

    def shift(self, x, offset: int = 1):
        return shift(x, self.group, self.index, self.n, offset, self.stats)

    def rotations(self, x):
        return rotations(x, self.group, self.index, self.n, self.stats)

    def all_gather(self, x, dim):
        return all_gather(x, dim, self.group, self.index, self.n)

    def psum(self, x):
        return all_reduce_autograd(x, self.group)

    def block(self, x, dim):
        """This rank's block of `x` along `dim` (n equal blocks)."""
        size = x.shape[dim] // self.n
        return x.narrow(dim, self.index * size, size)


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
