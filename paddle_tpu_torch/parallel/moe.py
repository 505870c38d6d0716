"""Expert parallelism: the Switch-style top-1 mixture-of-experts FFN with
all-to-all token dispatch over an 'expert' mesh axis (counterpart of
paddle_tpu/parallel/moe.py).

Routing (Switch Transformer, top-1): logits = x @ gate_w, expert =
argmax, and each token's output is scaled by its gate probability so the
router gets a gradient. Each rank builds an [E, C, D] dispatch buffer
(C = per-rank per-expert capacity; a token whose position in its
expert's queue reaches C is dropped and gets zero expert output), one
all-to-all hands every rank the tokens of ITS experts from every rank,
each expert runs one dense FFN over its [n*C, D] block, and the reverse
all-to-all returns the results to the tokens' owners.

A token's position in its expert's queue is counted in integers. The
JAX package counts it as a cumulative sum of one-hot rows in the
activation dtype (`moe.py:95-97`), which bf16 holds exactly only up to
256, so above that capacity its bf16 tokens share slots (ROADMAP Queue
C); in f32 the two are equal.

`expert_parallel_moe` keeps the JAX package's global contract: x and the
expert weights are the whole tensors on every rank; each rank takes its
block of the tokens and of the experts at the entry, and the result is
gathered over the axis at the exit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .collectives import MeshAxis

__all__ = ["expert_parallel_moe", "reference_moe", "moe_capacity",
           "moe_route"]


def moe_capacity(n_tokens_per_shard: int, n_experts: int,
                 capacity_factor: float = 1.25) -> int:
    """Per-rank per-expert slot count (the Switch capacity rule)."""
    return max(1, int(math.ceil(
        n_tokens_per_shard / n_experts * capacity_factor)))


def _expert_ffn(x, w1, b1, w2, b2):
    return torch.relu(x @ w1 + b1) @ w2 + b2


def _gate(x, gate_w):
    """(expert [N] int64, gate probability [N]) of top-1 routing."""
    logits = x @ gate_w
    probs = torch.softmax(logits, dim=-1)
    expert = torch.argmax(logits, dim=-1)
    return expert, torch.gather(probs, 1, expert[:, None])[:, 0]


def reference_moe(x, gate_w, w1, b1, w2, b2):
    """Single-device oracle: every token goes to its argmax expert (no
    all-to-all, no capacity truncation), its output scaled by the gate
    probability. x [N, D]; gate_w [D, E]; w1 [E, D, H]; b1 [E, H];
    w2 [E, H, D]; b2 [E, D]."""
    expert, gate = _gate(x, gate_w)
    outs = torch.relu(torch.einsum("nd,edh->enh", x, w1) + b1[:, None])
    outs = torch.einsum("enh,ehd->end", outs, w2) + b2[:, None]  # [E, N, D]
    picked = torch.gather(
        outs, 0, expert[None, :, None].expand(1, -1, outs.shape[2]))[0]
    return picked * gate[:, None]


def moe_route(expert, n_experts: int, capacity: int):
    """(slot [N], keep [N]) of tokens routed to `expert` [N]: each
    token's position among the earlier tokens of its expert, counted in
    int64, and whether that position is below `capacity`. `slot` is
    clipped into [0, capacity)."""
    onehot = torch.nn.functional.one_hot(expert, n_experts)  # int64
    pos = torch.gather(onehot.cumsum(0) - 1, 1, expert[:, None])[:, 0]
    return pos.clamp(0, capacity - 1), pos < capacity


def _moe_rank(x, gate_w, w1, b1, w2, b2, axis: MeshAxis, capacity: int):
    """One rank's body: x [n_local, D] its tokens; w1, b1, w2, b2 its
    experts [e_local, ...] (experts [index * e_local, (index+1) *
    e_local) of E). Returns [n_local, D] and the keep mask [n_local]."""
    n = axis.n
    E = gate_w.shape[1]
    e_local = E // n
    n_local, D = x.shape
    expert, gate = _gate(x, gate_w)
    slot, keep = moe_route(expert, E, capacity)
    if axis.stats is not None:
        axis.stats.dropped_tokens = (axis.stats.dropped_tokens
                                     + (~keep).sum())
    # dispatch [E, C, D]: each kept token in its (expert, slot) cell;
    # kept tokens' cells are distinct, dropped ones add zeros
    kept = torch.where(keep[:, None], x, torch.zeros_like(x))
    flat = (expert * capacity + slot)[:, None].expand(-1, D)
    dispatch = x.new_zeros((E * capacity, D)).scatter_add(0, flat, kept)
    dispatch = dispatch.reshape(n, e_local, capacity, D)
    # peer s's tokens for this rank's experts: [n, e_local, C, D]
    recv = axis.all_to_all(dispatch, 0, 0)
    tokens = recv.transpose(0, 1).reshape(e_local, n * capacity, D)
    h = torch.relu(torch.bmm(tokens, w1) + b1[:, None])
    out = (torch.bmm(h, w2) + b2[:, None]).reshape(e_local, n, capacity, D)
    back = axis.all_to_all(out.transpose(0, 1).contiguous(), 0, 0)
    back = back.reshape(E * capacity, D)
    y = torch.gather(back, 0, flat)  # each token's (expert, slot) cell
    y = torch.where(keep[:, None], y, torch.zeros_like(y))
    return y * gate[:, None], keep


def expert_parallel_moe(x, gate_w, w1, b1, w2, b2, mesh,
                        axis: str = "expert", capacity_factor: float = 1.25,
                        capacity: Optional[int] = None,
                        return_keep: bool = False):
    """Top-1 MoE FFN with the experts split over `axis` of `mesh`.

    x: [N, D] tokens, split over the axis along N (N divisible by its
    extent); the expert weights split along their leading E. Both are
    given whole, the same on every rank. Returns [N, D], the same on
    every rank (and with `return_keep`, the [N] bool mask of the tokens
    that found a slot). Each rank adds the tokens of its block that found
    no slot to `mesh.sync_stats.dropped_tokens`."""
    n = mesh.shape[axis]
    E = gate_w.shape[1]
    if E % n:
        raise ValueError("n_experts %d must divide over %d shards" % (E, n))
    if x.shape[0] % n:
        raise ValueError("token count %d must divide over %d shards"
                         % (x.shape[0], n))
    if capacity is None:
        capacity = moe_capacity(x.shape[0] // n, E, capacity_factor)
    ax = MeshAxis.of(mesh, axis)
    y, keep = _moe_rank(ax.block(x, 0), gate_w,
                        *(ax.block(w, 0) for w in (w1, b1, w2, b2)),
                        axis=ax, capacity=capacity)
    y = ax.all_gather(y, 0)
    if return_keep:
        return y, ax.all_gather(keep.to(torch.uint8), 0).bool()
    return y
