"""One rank's view of a run on a mesh (the executor's SPMD path; in the
JAX package XLA's partitioner does all of this inside one compiled step).

Every rank runs the program over its shard of the global batch. The
marks below keep the run's arithmetic the single-device arithmetic on
the concatenated global batch:

- A value is *split* when each rank holds one block of it along a
  dimension, over some mesh axes (`Split(dim, axes)`): a dense feed along
  dim 0 over the data-parallel axes (the batch mark), and a parameter
  with a spec over its spec's axes (a shard). The marks travel from op
  to op by name, as LoD side-bands do (`propagate`): an op's outputs
  take its first split input's mark when they keep that dimension.
- An op that reduces over a split dimension ends in a collective: its
  kernel computes the global form (a `mean` loss, the batch-norm
  statistics, `accuracy`, `auc`, dropout's mask, ...). An op that would
  mix blocks and has no global form here raises, naming itself
  (`RAISING_OPS`, `_MIXES`); it never computes a per-rank answer.
- A parameter with a spec is held as this rank's shard (1/n of it). The
  forward reads it gathered (`forward_reads`), so its gradient comes
  back reduce-scattered; a table row-sharded over an axis and read only
  by `lookup_table` stays a shard and is looked up in place
  (parallel/embedding.py).
- The backward of a loss that every rank holds is seeded with 1 / (the
  mesh's ranks) (`loss_seed`), every collective's backward is its exact
  adjoint, and each gradient is then summed over the axes its parameter
  is not split over (`sync_dense`, `sync_sparse`): the result is the
  exact global-batch gradient whatever mix of split and replicated
  values the loss came through (a ragged feed, which every rank holds
  whole, included).

A data-parallel extent of 1 marks no batch: such a mesh runs the
single-device arithmetic bit for bit, with the gradient sync on the
world's group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ...parallel import collectives
from ...parallel.mesh import data_parallel_axes
from .selected_rows import SelectedRows

__all__ = ["Split", "SpmdContext", "spec_split", "RAISING_OPS",
           "TRACKED_OPS"]


class Split(NamedTuple):
    dim: int
    axes: Tuple[str, ...]


def spec_split(spec) -> Optional[Split]:
    """The Split of a PartitionSpec, or None for a replicated one. A spec
    splits one dimension in this port."""
    entries = [(d, e) for d, e in enumerate(tuple(spec)) if e is not None]
    if not entries:
        return None
    if len(entries) > 1:
        raise NotImplementedError(
            "spec %r splits %d dimensions; the port's mesh executor splits "
            "one (ROADMAP Queue A)" % (tuple(spec), len(entries)))
    d, e = entries[0]
    return Split(d, (e,) if isinstance(e, str) else tuple(e))


# ops whose kernel computes the global form of a reduction over a split
# dimension and marks its outputs itself; `dropout`,
# `gaussian_random_noise`, `nce`, `sampling_id` and `clip_by_norm` have
# global forms too (a slice of the global draw, a global norm) and keep
# the row-wise marking of their outputs
_MANAGED = frozenset([
    "mean", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "batch_norm", "accuracy", "auc", "squared_l2_norm",
    "l1_norm", "lookup_table"])

# ops that mix the rows of a split value and have no global form here
RAISING_OPS = frozenset([
    "chunk_eval", "precision_recall", "edit_distance", "detection_map",
    "pnpair_eval", "lambda_rank", "ctc_align", "warpctc",
    "linear_chain_crf", "crf_decoding", "multiclass_nms",
    "ssd_multibox_loss", "bipartite_match", "prior_box", "box_coder",
    "roi_pool", "scatter", "shape", "is_empty", "isfinite", "im2sequence",
    "row_conv", "lod_reset", "lod_rank_table", "max_sequence_len",
    "reorder_lod_tensor_by_rank", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_rnn_memory", "split_lod_tensor",
    "merge_lod_tensor", "beam_search", "beam_search_decode", "beam_init",
    "while", "dynamic_rnn", "array_write", "array_read", "array_length",
    "lstm", "gru", "lstmp", "sub_nested_seq", "kmax_seq_score",
    "cross_entropy_over_beam", "crop", "sequence_pool", "sequence_concat",
    "sequence_context", "sequence_conv", "sequence_erase",
    "sequence_expand", "sequence_mask", "sequence_reshape",
    "sequence_reverse", "sequence_slice", "sequence_softmax"])

# ops whose output moves the split dimension
TRACKED_OPS = frozenset(["transpose", "squeeze", "unsqueeze", "reshape"])


def _norm(d, nd):
    return d % nd if nd else d


def _list(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _in_dims(attrs, key, s, nd, default=None):
    v = attrs.get(key, default)
    return v is not None and s in [_norm(int(a), nd) for a in _list(v)]


# op -> predicate(attrs, split dim, rank of the split input, split
# input slots): True when the op mixes the blocks of that dimension
_MIXES = {
    "concat": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, 0),
    "split": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, 0),
    "slice": lambda a, s, nd, sl: _in_dims(a, "axes", s, nd, []),
    "cumsum": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, -1),
    "reverse": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, []),
    "softmax": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, -1),
    "log_softmax": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, -1),
    "l2_normalize": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, -1),
    "norm": lambda a, s, nd, sl: _in_dims(a, "axis", s, nd, 1),
    "layer_norm": lambda a, s, nd, sl: a.get("begin_norm_axis", 1) <= s,
    "pad": lambda a, s, nd, sl: any(
        _list(a.get("paddings", []))[2 * s:2 * s + 2]),
    "expand": lambda a, s, nd, sl: _list(
        a.get("expand_times", [1] * (s + 1)))[s] != 1,
    "gather": lambda a, s, nd, sl: "X" in sl,
    "mul": lambda a, s, nd, sl: "Y" in sl,
    "matmul": lambda a, s, nd, sl: "Y" in sl and ("X" not in sl or nd < 3),
    "squeeze": lambda a, s, nd, sl: _in_dims(a, "axes", s, nd, []),
    "reshape": lambda a, s, nd, sl: s != 0,
    "fill_constant_batch_size_like": lambda a, s, nd, sl:
        a.get("input_dim_idx", 0) != s,
}
for _op in ("elementwise_add", "elementwise_sub", "elementwise_mul",
            "elementwise_div", "elementwise_max", "elementwise_min",
            "elementwise_pow"):
    _MIXES[_op] = lambda a, s, nd, sl: "X" not in sl


def _moved(op, s, nd):
    """The split dimension of op's outputs, given its input's `s`."""
    t = op.type
    if t == "transpose":
        return list(op.attrs["axis"]).index(s)
    if t == "unsqueeze":
        for a in sorted(int(a) for a in op.attrs.get("axes", [])):
            if a <= s:
                s += 1
        return s
    if t == "squeeze":
        axes = [_norm(int(a), nd) for a in op.attrs.get("axes", [])]
        return s - sum(1 for a in axes if a < s)
    if t == "reshape":
        return 0
    if t == "fill_constant_batch_size_like":
        return op.attrs.get("output_dim_idx", 0)
    return s


class SpmdContext(object):
    """The marks and collectives of one run on `mesh`; `specs` maps each
    persistable with a spec to (its Split, its full shape)."""

    def __init__(self, mesh, specs: Dict[str, tuple]):
        self.mesh = mesh
        axes, n = data_parallel_axes(mesh)
        self.data_axes = axes
        self.batch = Split(0, axes) if n > 1 else None
        self.specs = specs
        self.split: Dict[str, Split] = {}

    # --- the mesh -------------------------------------------------------
    def extent(self, axes) -> int:
        return self.mesh.extent(axes)

    def index(self, axes) -> int:
        return self.mesh.index(axes)

    def all_reduce(self, t, axes):
        """Sum over the ranks of `axes`, differentiable."""
        return collectives.all_reduce_autograd(t, self.mesh.group(axes))

    def gather(self, t, split: Split):
        """The whole value of a block split by `split`, differentiable."""
        return collectives.all_gather(
            t, split.dim, self.mesh.group(split.axes),
            self.index(split.axes), self.extent(split.axes))

    def shard(self, t, split: Split):
        """This rank's block of a whole value."""
        n = self.extent(split.axes)
        size = t.shape[split.dim] // n
        return t.narrow(split.dim, self.index(split.axes) * size,
                        size).clone()

    def complement(self, axes):
        return tuple(a for a in self.mesh.axis_names if a not in axes)

    # --- marks ----------------------------------------------------------
    def split_of(self, name) -> Optional[Split]:
        return self.split.get(name)

    def input_split(self, ctx, slot, i=0) -> Optional[Split]:
        names = ctx.op.inputs.get(slot) or ()
        return self.split.get(names[i]) if len(names) > i else None

    def mark(self, name, split: Optional[Split]):
        if split is None:
            self.split.pop(name, None)
        else:
            self.split[name] = split

    def propagate(self, op, env):
        """Mark op's outputs after it ran: each output that keeps the
        split dimension of op's first split input takes its mark. Raises
        for an op that mixes the split dimension's blocks."""
        if not self.split or op.type in _MANAGED:
            return
        first, slots = None, set()
        for slot, names in op.inputs.items():
            for n in names:
                sp = self.split.get(n)
                if sp is not None:
                    slots.add(slot)
                    if first is None:
                        first = (n, sp)
        if first is None:
            return
        name, sp = first
        src = env.get(name)
        nd = src.dim() if isinstance(src, torch.Tensor) else 0
        check = _MIXES.get(op.type)
        if op.type in RAISING_OPS or (
                check is not None and check(op.attrs, sp.dim, nd, slots)):
            raise NotImplementedError(
                "op %r reads %r, split along dim %d over mesh axes %s, and "
                "has no global form on a mesh in this port (ROADMAP Queue "
                "A, the mesh's batch-axis ops): it would compute a "
                "per-rank answer" % (op.type, name, sp.dim, sp.axes))
        d = _moved(op, sp.dim, nd)
        size = src.shape[sp.dim] if nd > sp.dim else None
        for names in op.outputs.values():
            for n in names:
                v = env.get(n)
                if isinstance(v, torch.Tensor) and v.dim() > d and (
                        op.type in TRACKED_OPS or v.shape[d] == size):
                    self.split[n] = Split(d, sp.axes)

    # --- random ops over a split batch ----------------------------------
    def global_draw(self, shape, split: Split):
        """(global shape, flat offset of this rank's block) of a draw
        whose local shape is `shape`, split along dim 0: the rank draws
        its rows of the single-device draw over the global batch."""
        if split.dim != 0:
            raise NotImplementedError(
                "a random draw split along dim %d (the port draws a "
                "rank's rows of dim 0)" % split.dim)
        n = self.extent(split.axes)
        numel = 1
        for s in shape:
            numel *= int(s)
        return (int(shape[0]) * n,) + tuple(shape[1:]), \
            self.index(split.axes) * numel

    # --- parameters with a spec -----------------------------------------
    def is_shard(self, name, value) -> bool:
        entry = self.specs.get(name)
        return entry is not None and isinstance(value, torch.Tensor) and \
            tuple(value.shape) != tuple(entry[1])

    def to_shard(self, name, value):
        """`value` as this rank's shard (sliced when it is whole)."""
        if self.specs.get(name) is None or self.is_shard(name, value):
            return value
        return self.shard(value, self.specs[name][0])

    def forward_reads(self, ops, fenv, sparse=()):
        """Bind, in `fenv`, every persistable with a spec that `ops` read:
        gathered whole (differentiable, so a leaf's gradient comes back
        reduce-scattered), or left a shard and marked when it is a table
        split along its rows that only `lookup_table` reads (and every
        table of the sparse-gradient path). Returns {name: bound}."""
        readers: Dict[str, list] = {}
        for op in ops:
            for n in op.input_arg_names:
                if n in self.specs:
                    readers.setdefault(n, []).append(op)
        bound = {}
        for n, ops_r in readers.items():
            v = fenv.get(n)
            if v is None:
                continue
            split = self.specs[n][0]
            kept = n in sparse or (split.dim == 0 and all(
                o.type == "lookup_table" and o.inputs.get("W") == [n]
                for o in ops_r))
            if kept:
                self.mark(n, split)
            else:
                fenv[n] = self.gather(v, split)
            bound[n] = fenv[n]
        return bound

    def mark_shards(self, env, grad_names=None):
        """Mark every shard in `env` and the gradients of the parameters
        with a spec (the tail's view: the optimizer ops update shards)."""
        for n, (split, _full) in self.specs.items():
            if self.is_shard(n, env.get(n)):
                self.mark(n, split)
                g = (grad_names or {}).get(n)
                if g is not None and isinstance(env.get(g), torch.Tensor):
                    self.mark(g, split)

    # --- the backward ---------------------------------------------------
    def loss_seed(self, loss_name) -> float:
        """The upstream gradient of the loss on this rank: 1 / ranks for a
        loss every rank holds (times the extent of a split loss's axes)."""
        sp = self.split.get(loss_name)
        return (self.extent(sp.axes) if sp else 1) / float(self.mesh.size)

    def _sync_axes(self, name):
        entry = self.specs.get(name)
        return self.complement(entry[0].axes if entry else ())

    def sync_dense(self, grads: Dict[str, torch.Tensor]):
        """Each gradient summed over the axes its parameter is not split
        over, in buckets per group."""
        by_axes: Dict[tuple, dict] = {}
        for p, g in grads.items():
            by_axes.setdefault(self._sync_axes(p), {})[p] = g
        out = {}
        for axes, gs in by_axes.items():
            out.update(collectives.sync_gradients(
                gs, self.mesh.group(axes) if axes else None,
                self.mesh.sync_stats))
        return out

    def sync_sparse(self, name, sr: SelectedRows) -> SelectedRows:
        """A sparse gradient gathered (rows and values concatenated) over
        the axes its table is not split over: duplicates sum."""
        axes = self._sync_axes(name)
        if not axes or self.mesh.group(axes) is None:
            return sr
        group = self.mesh.group(axes)
        n, i = self.extent(axes), self.index(axes)
        rows = collectives.all_gather(sr.rows, 0, group, i, n)
        vals = collectives.all_gather(sr.values, 0, group, i, n)
        return SelectedRows(rows, vals, sr.height)
