"""Pipeline parallelism: the GPipe-style microbatch pipeline over a 'pipe'
mesh axis (counterpart of paddle_tpu/parallel/pipeline.py).

Every rank holds ONE stage's parameters and activations flow stage to
stage with one `MeshAxis.shift` a tick. With M microbatches and S
stages the schedule runs M + S - 1 ticks: stage 0 injects microbatch t
at tick t, every stage applies its body to what it holds, the last
stage banks microbatch t - (S - 1) as it completes, and the result is
replicated over the axis with a sum (only the last stage's bank is
non-zero). The stage body must keep its shape ([mb, D] -> [mb, D]) so
one rotating buffer serves every stage. Differentiable end to end: the
shift's backward is the reverse shift, so the backward runs as the
reverse pipeline.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.tree import leaves as _leaves
from ..utils.tree import tree_map as _tree_map
from .collectives import MeshAxis

__all__ = ["gpipe_pipeline", "reference_pipeline"]


def reference_pipeline(stage_fn: Callable, stage_params, x):
    """Sequential oracle: fold x through every stage on one device.
    stage_params: a tree whose leaves have a leading stage dim [S, ...]."""
    S = _leaves(stage_params)[0].shape[0]
    out = x
    for s in range(S):
        out = stage_fn(_tree_map(lambda a: a[s], stage_params), out)
    return out


def _pipe_rank(stage_fn, params, x, axis: MeshAxis, n_micro: int):
    """One rank's body: `params` THIS rank's stage (no stage dim); x the
    whole input, read by stage 0 only."""
    S, stage = axis.n, axis.index
    B, D = x.shape
    micro = x.reshape(n_micro, B // n_micro, D)
    state = x.new_zeros(micro.shape[1:])
    bank = []
    n_ticks = n_micro + S - 1
    for t in range(n_ticks):
        # stage 0 injects microbatch t; a select, not a branch, so every
        # rank's graph (and so its backward's collectives) is the same
        inject = torch.tensor(stage == 0 and t < n_micro, device=x.device)
        state = torch.where(inject, micro[min(t, n_micro - 1)], state)
        state = stage_fn(params, state)
        if t >= S - 1:  # microbatch t - (S - 1) completes on the last stage
            bank.append(state)
        if t + 1 < n_ticks:  # the last tick's send goes unused
            state = axis.shift(state)
    # every rank banks and sums alike (so the backward's collectives
    # match on every rank); only the last stage's bank is non-zero
    bank = torch.stack(bank)
    last = torch.tensor(stage == S - 1, device=x.device)
    bank = torch.where(last, bank, torch.zeros_like(bank))
    return axis.psum(bank).reshape(B, D)


def gpipe_pipeline(stage_fn: Callable, stage_params, x, mesh,
                   axis: str = "pipe", n_microbatches: int = 4,
                   stage_local: bool = False):
    """Run x through S pipeline stages over `axis` of `mesh`.

    stage_fn(params_one_stage, x_mb) -> y_mb, shape-preserving.
    stage_params: a tree whose leaves have a leading stage dim S equal
    to the axis's extent (each rank takes its own stage), or with
    `stage_local` a leading dim of 1 holding this rank's stage only.
    x: [B, D] with B divisible by n_microbatches, the same on every
    rank. Returns [B, D], the same on every rank."""
    S = mesh.shape[axis]
    leaves = _leaves(stage_params)
    want = 1 if stage_local else S
    if not leaves or leaves[0].shape[0] != want:
        raise ValueError(
            "stage_params leading dim must equal the '%s' axis size %d"
            % (axis, S) if not stage_local else
            "stage_local params must have a leading stage dim of 1")
    if x.shape[0] % n_microbatches:
        raise ValueError("batch %d must divide into %d microbatches"
                         % (x.shape[0], n_microbatches))
    ax = MeshAxis.of(mesh, axis)
    i = 0 if stage_local else ax.index
    mine = _tree_map(lambda a: a[i], stage_params)
    return _pipe_rank(stage_fn, mine, x, ax, n_microbatches)
