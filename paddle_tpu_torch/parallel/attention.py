"""Sequence/context-parallel attention (counterpart of
paddle_tpu/parallel/attention.py): ring attention, its zigzag (striped)
causal form and Ulysses, over a mesh's 'seq' axis.

* ring_attention — each rank holds a [T/n] block of the rows; K/V
  blocks go round the axis (n - 1 shifts, `MeshAxis.rotations`) and an
  online
  softmax folds each one in, so the result equals full attention. A
  causal source block wholly to the right of a rank's rows is skipped.
* zigzag_ring_attention — the balanced causal ring: rank i holds stripe
  i and its mirror 2n-1-i, so every rank does about the same work a
  step (the layout `zigzag_permutation` builds).
* ulysses_attention — heads are exchanged for sequence
  (`MeshAxis.all_to_all`), each rank attends the whole sequence for
  H/n heads, and the inverse exchange restores the layout; with
  impl="flash" the local attention is the flash kernels' (forward and
  both backward passes on CUDA tensors).

The per-rank bodies take a `MeshAxis` where the JAX package's take an
axis name inside shard_map. `sequence_parallel_attention` keeps the JAX
package's global contract: q, k, v are the whole [B, T, H, D] tensors
on every rank; each rank takes its block of the rows at the entry and
the result is gathered over the axis at the exit, the same on every
rank. The ring steps are plain torch matmuls with f32 scores and
statistics, as the JAX package computes them outside any Pallas
kernel; the exchanges go through the one sum all-reduce of
collectives.py, so they are exact on NCCL and gloo alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .collectives import MeshAxis
from .kernel_utils import NEG_INF

__all__ = ["reference_attention", "ring_attention", "zigzag_ring_attention",
           "zigzag_permutation", "ulysses_attention",
           "sequence_parallel_attention"]


def reference_attention(q, k, v, causal: bool = False, scale=None):
    """Plain full attention over [B, T, H, D] tensors: the scale is
    folded into q BEFORE the QK^T matmul and masked scores take the
    finite NEG_INF fill — the numerics family the chunked prefill and
    verify paths share."""
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    s = torch.einsum("bthd,bshd->bhts", q * scale, k)
    if causal:
        S = k.shape[1]
        mask = torch.ones(T, S, dtype=torch.bool, device=q.device).tril(S - T)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v)


def _scores(q, k, scale):
    """f32 scores of q [B, T, H, D] against k [B, S, H, D]: the inputs'
    products accumulated in f32 (the JAX package's
    preferred_element_type), the scale applied to the f32 result."""
    return torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale


def _online_softmax_update(o, l, m, s, vs):
    """One online-softmax accumulation over a pre-masked f32 score tile
    `s` [B, H, T, S]: rescale the running (o [B, T, H, D], l, m
    [B, H, T]) by the max shift and fold in this tile's contribution.
    The NEG_INF guards keep fully-masked rows at exact zero (exp never
    sees inf - inf). Shared by both ring layouts."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    safe = torch.where(m_new <= NEG_INF, torch.zeros_like(m_new), m_new)
    p = torch.exp(s - safe[..., None])
    p = torch.where(s <= NEG_INF, torch.zeros_like(p), p)
    corr = torch.where(m <= NEG_INF, torch.zeros_like(m),
                       torch.exp(m - safe))
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr.transpose(1, 2)[..., None] + torch.einsum(
        "bhts,bshd->bthd", p.to(vs.dtype).float(), vs.float())
    return o_new, l_new, m_new


def _finish(o, l, dtype):
    return (o / l.clamp_min(1e-30).transpose(1, 2)[..., None]).to(dtype)


def _init_state(q, T):
    B, _, H, D = q.shape
    return (q.new_zeros((B, T, H, D), dtype=torch.float32),
            q.new_zeros((B, H, T), dtype=torch.float32),
            q.new_full((B, H, T), NEG_INF, dtype=torch.float32))


def ring_attention(q, k, v, axis: MeshAxis, causal: bool = False,
                   scale=None):
    """Blockwise ring attention on this rank's blocks q, k, v
    [B, T/n, H, D] of the rows (rank i holds rows [i T/n, (i+1) T/n))."""
    n, me = axis.n, axis.index
    B, T, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    q_pos = me * T + torch.arange(T, device=q.device)
    o, l, m = _init_state(q, T)
    # step i holds the K/V block of rank (me - i) % n
    kv = axis.rotations(torch.stack([k, v]))
    for i in range(n):
        src = (me - i) % n
        # causal: a source block wholly right of this rank's rows is
        # fully masked, so both matmuls are skipped
        if causal and src > me:
            continue
        s = _scores(q, kv[i, 0], scale)
        if causal:
            k_pos = src * T + torch.arange(T, device=q.device)
            keep = q_pos[:, None] >= k_pos[None, :]
            s = s.masked_fill(~keep, NEG_INF)
        o, l, m = _online_softmax_update(o, l, m, s, kv[i, 1])
    return _finish(o, l, q.dtype)


def zigzag_ring_attention(q, k, v, axis: MeshAxis, causal: bool = True,
                          scale=None):
    """Causal ring attention in the zigzag layout: this rank's q, k, v
    [B, T_local, H, D] hold stripe `index` (rows [:C]) and its mirror
    stripe 2n-1-index (rows [C:]), C = T_local / 2. Per (q stripe, k
    stripe) pair the mask is decided at stripe granularity: a later
    stripe sees all of an earlier one, equal stripes the tril diagonal,
    and a front stripe never sees a mirror one."""
    if not causal:
        raise ValueError("zigzag ring attention is causal-only; use "
                         "ring_attention for the non-causal case")
    n, me = axis.n, axis.index
    B, T, H, D = q.shape
    C = T // 2
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    tril = torch.ones(C, C, dtype=torch.bool, device=q.device).tril()
    qf, qm = q[:, :C], q[:, C:]

    def attend(state, qs, ks, vs, masked):
        s = _scores(qs, ks, scale)
        if masked:
            s = s.masked_fill(~tril, NEG_INF)
        return _online_softmax_update(*state, s, vs)

    front, mirror = _init_state(q, C), _init_state(q, C)
    kv = axis.rotations(torch.stack([k, v]))
    for i in range(n):
        src = (me - i) % n
        kf, km = kv[i, 0, :, :C], kv[i, 0, :, C:]
        vf, vm = kv[i, 1, :, :C], kv[i, 1, :, C:]
        # front q stripe (me) vs the source's front stripe (src)
        if me >= src:
            front = attend(front, qf, kf, vf, me == src)
        # the mirror q stripe always follows every front stripe
        mirror = attend(mirror, qm, kf, vf, False)
        # mirror vs mirror: stripe 2n-1-me vs 2n-1-src, order inverted
        if me <= src:
            mirror = attend(mirror, qm, km, vm, me == src)
    return torch.cat([_finish(front[0], front[1], q.dtype),
                      _finish(mirror[0], mirror[1], q.dtype)], dim=1)


def zigzag_permutation(T_global: int, n: int):
    """Row permutation taking the natural sequence order to the zigzag
    layout: rank i's contiguous block holds stripe i then stripe
    2n-1-i. Returns (perm, inverse) index arrays of length T_global."""
    C = T_global // (2 * n)
    order = []
    for i in range(n):
        order.append(np.arange(i * C, (i + 1) * C))
        j = 2 * n - 1 - i
        order.append(np.arange(j * C, (j + 1) * C))
    perm = np.concatenate(order)
    return perm, np.argsort(perm)


def ulysses_attention(q, k, v, axis: MeshAxis, causal: bool = False,
                      scale=None, impl: str = "reference"):
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism on this
    rank's blocks [B, T/n, H, D]; needs H % n == 0. After the
    head<->sequence exchange this rank holds the whole sequence of its
    H/n heads, the single-device problem: impl="flash" runs the flash
    kernels on it (made contiguous first: the exchange's output is a
    concatenation, and the kernels take contiguous inputs only), any
    other impl the plain full attention."""
    qg, kg, vg = (axis.all_to_all(t, 2, 1) for t in (q, k, v))
    if impl == "flash":
        from .flash_attention import flash_attention

        og = flash_attention(qg.contiguous(), kg.contiguous(),
                             vg.contiguous(), causal=causal, scale=scale)
    else:
        og = reference_attention(qg, kg, vg, causal=causal, scale=scale)
    return axis.all_to_all(og, 1, 2)


def _zigzag_entry(q, k, v, mesh, axis, causal, scale):
    """Global-view zigzag: permute the rows to the striped layout, take
    this rank's block, run the balanced causal ring, gather and
    un-permute."""
    if not causal:
        raise ValueError("impl='zigzag' is causal-only")
    n = mesh.shape[axis]
    T = q.shape[1]
    if T % (2 * n) != 0:
        raise ValueError(
            "zigzag needs the sequence length (%d) divisible by 2*axis "
            "size (%d)" % (T, 2 * n))
    ax = MeshAxis.of(mesh, axis)
    perm, inv = (torch.as_tensor(a, device=q.device)
                 for a in zigzag_permutation(T, n))
    mine = [ax.block(t.index_select(1, perm), 1) for t in (q, k, v)]
    out = zigzag_ring_attention(*mine, axis=ax, causal=True, scale=scale)
    return ax.all_gather(out, 1).index_select(1, inv)


def sequence_parallel_attention(q, k, v, mesh=None, axis: str = "seq",
                                impl: str = "ring", causal: bool = False,
                                scale=None):
    """Global-view entry point: q, k, v are the [B, T, H, D] tensors,
    the same on every rank; the sequence dim is split over `axis` of
    `mesh` (the default mesh when None) and attention runs
    sequence-parallel, the result gathered on every rank. Without a
    mesh, or on an axis of extent 1: impl="flash" runs `flash_attention`
    (the Hopper kernels on CUDA tensors), anything else
    `reference_attention`. On the axis, impl="flash" becomes Ulysses
    with the flash kernels when the heads divide over it and the ring
    when they do not."""
    if mesh is None:
        from .mesh import get_default_mesh

        mesh = get_default_mesh()
    if impl == "zigzag" and not causal:
        # checked BEFORE the no-mesh branch so a one-device run fails
        # the same way the multi-rank run will
        raise ValueError("impl='zigzag' is causal-only")
    if mesh is None or axis not in mesh.axis_names or mesh.shape[axis] == 1:
        if impl == "flash":
            from .flash_attention import flash_attention

            return flash_attention(q, k, v, causal=causal, scale=scale)
        return reference_attention(q, k, v, causal=causal, scale=scale)
    n = mesh.shape[axis]
    if q.shape[1] % n != 0:
        raise ValueError(
            "sequence length %d not divisible by mesh axis %r size %d"
            % (q.shape[1], axis, n))
    inner = "reference"
    if impl == "flash":
        # Ulysses puts a whole sequence on each rank, where the flash
        # kernels apply unchanged; heads that do not divide over the
        # axis take the ring
        inner = "flash"
        impl = "ulysses" if q.shape[2] % n == 0 else "ring"
    if impl == "zigzag":
        return _zigzag_entry(q, k, v, mesh, axis, causal, scale)
    if impl not in ("ring", "ulysses"):
        raise KeyError(impl)
    if impl == "ulysses" and q.shape[2] % n != 0:
        raise ValueError("ulysses needs heads divisible by the seq axis size")
    ax = MeshAxis.of(mesh, axis)
    mine = [ax.block(t, 1) for t in (q, k, v)]
    if impl == "ring":
        out = ring_attention(*mine, axis=ax, causal=causal, scale=scale)
    else:
        out = ulysses_attention(*mine, axis=ax, causal=causal, scale=scale,
                                impl=inner)
    return ax.all_gather(out, 1)
