"""Sequence (LoD / ragged) op kernels (counterpart of
paddle_tpu/fluid/core/kernels_sequence.py, as plain torch ops).

A ragged batch is a packed `[total_tokens, ...]` tensor plus an int32
offsets vector `[batch+1]` stored in the environment under
`<name>@LOD0`, on the device. The number of sequences is the offsets'
static length; the segment reductions are `index_add` / `scatter_reduce`
over segment ids from `torch.searchsorted`, so no kernel reads offsets
back to the host.

The packed-compaction outputs (sequence_slice, sequence_erase,
split_lod_tensor, and ctc_align in kernels_ctc.py) keep the JAX
package's layout: a buffer of the input's size whose kept rows are
compacted to the front, with device offsets that describe the kept
prefix.

Parity: operators/sequence_pool_op, sequence_softmax_op,
sequence_expand_op, sequence_slice_op, sequence_concat, lod_reset,
sequence_reshape, sequence_erase, and the LoD plumbing ops of the
reference's layers/control_flow.py.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels_nn import stable_topk
from .registry import register_op

LOD_SUFFIX = "@LOD0"
# outer (source-sentence) level of a 2-level LoD (the JAX package's
# kernels_control.py)
LOD_SRC = "@LOD_SRC"
# beam-search states: explicit parent pointers of each row
BEAM_PARENTS = "@BEAM_PARENTS"
# a padded detection buffer's rows per image (kernels_detection.py)
PAD_STRIDE = "@PAD_STRIDE"


def lod_key(name: str) -> str:
    return name + LOD_SUFFIX


def _offsets(ctx, slot="X", idx=0):
    name = ctx.op.inputs[slot][idx]
    key = lod_key(name)
    if key not in ctx.env:
        raise ValueError(
            "op %r input %r has no LoD offsets in scope; feed it as a "
            "(data, lod) pair or via create_lod_tensor" % (ctx.op.type, name)
        )
    return ctx.env[key]


def _set_lod(ctx, slot, offsets, idx=0, host=None):
    ctx.set_lod(ctx.op.outputs[slot][idx], offsets, host)


def _i32(t):
    return t.to(torch.int32)


def _zero1(like):
    return torch.zeros((1,), dtype=torch.int32, device=like.device)


def _cum_offsets(lengths):
    """[0, cumsum(lengths)] as int32 offsets."""
    return torch.cat([_zero1(lengths),
                      torch.cumsum(lengths, 0, dtype=torch.int32)])


def seg_ids(offsets, total: int):
    """Map packed positions -> sequence index (int64). offsets: [N+1]."""
    pos = torch.arange(total, dtype=offsets.dtype, device=offsets.device)
    return torch.searchsorted(offsets.contiguous(), pos, right=True) - 1


def seg_lengths(offsets):
    return offsets[1:] - offsets[:-1]


def _col(v, ndim):
    """[n] -> [n, 1, ...] broadcastable against an [n, ...] tensor."""
    return v.reshape((-1,) + (1,) * (ndim - 1))


def segment_sum(x, ids, n):
    """Per-segment sums. Rows past the last offset (id n: the padding of a
    static buffer, as sub_nested_seq leaves) land in a spill row that is
    dropped, as the JAX package's segment_sum drops them."""
    return torch.zeros((n + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)[:n]


def segment_max(x, ids, n):
    """Per-segment max; an empty segment holds -inf (rows past the last
    offset are dropped, as in segment_sum)."""
    idx = _col(ids, x.dim()).expand_as(x)
    return torch.full((n + 1,) + tuple(x.shape[1:]), float("-inf"),
                      dtype=x.dtype, device=x.device).scatter_reduce(
        0, idx, x, "amax", include_self=False)[:n]


def _compact(x, kept, total):
    """Rows of `x` where `kept`, moved in order to the front of a
    zero buffer of `total` rows (dropped rows go to a spill slot)."""
    pos = torch.cumsum(kept.to(torch.int64), 0) - 1
    dest = torch.where(kept, pos, torch.full_like(pos, total))
    buf = torch.zeros((total + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return buf.index_copy(0, dest, x)[:total]


@register_op("sequence_pool")
def _sequence_pool(ctx, ins, attrs):
    x = ins["X"][0]
    offsets = _offsets(ctx)
    n = offsets.shape[0] - 1
    ptype = attrs.get("pooltype", attrs.get("pool_type", "AVERAGE")).upper()
    ids = seg_ids(offsets, x.shape[0])
    if ptype in ("SUM", "AVERAGE", "SQRT"):
        out = segment_sum(x, ids, n)
        cnt = _col(seg_lengths(offsets).to(x.dtype), x.dim())
        if ptype == "AVERAGE":
            out = out / torch.clamp(cnt, min=1)
        elif ptype == "SQRT":
            out = out / torch.sqrt(torch.clamp(cnt, min=1))
    elif ptype == "MAX":
        out = segment_max(x, ids, n)
        empty = _col(seg_lengths(offsets) == 0, x.dim())
        out = torch.where(empty, torch.zeros_like(out), out)
    elif ptype == "FIRST":
        out = x.index_select(0, offsets[:-1].long())
    elif ptype == "LAST":
        out = x.index_select(0, torch.clamp(offsets[1:] - 1, min=0).long())
    else:
        raise ValueError("unknown pooltype %r" % ptype)
    return {"Out": out, "MaxIndex": torch.zeros((n,), dtype=torch.int32,
                                                device=x.device)}


@register_op("sequence_softmax")
def _sequence_softmax(ctx, ins, attrs):
    x = ins["X"][0]  # [T] or [T, 1]
    offsets = _offsets(ctx)
    n = offsets.shape[0] - 1
    flat = x.reshape(-1)
    ids = seg_ids(offsets, flat.shape[0])
    # the shift cancels in the softmax: no gradient flows through it
    mx = segment_max(flat.detach(), ids, n)
    e = torch.exp(flat - mx[ids])
    denom = segment_sum(e, ids, n)
    out = (e / denom[ids]).reshape(x.shape)
    _set_lod(ctx, "Out", offsets)
    return {"Out": out}


@register_op("sequence_expand")
def _sequence_expand(ctx, ins, attrs):
    """Repeat each row/sequence of X according to Y's LoD
    (operators/sequence_expand_op.cc)."""
    x = ins["X"][0]
    y_name = ctx.op.inputs["Y"][0]
    # beam-search states: Y carries explicit parent pointers (control
    # flow) — each Y row gets its parent's X row
    parents = ctx.env.get(y_name + BEAM_PARENTS)
    if parents is not None:
        _set_lod(ctx, "Out", ctx.env[lod_key(y_name)])
        return {"Out": x.index_select(0, parents.long())}
    y_offsets = _offsets(ctx, "Y")
    ids = seg_ids(y_offsets, ins["Y"][0].shape[0])
    x_offsets = ctx.env.get(lod_key(ctx.op.inputs["X"][0]))
    if x_offsets is not None:
        # lod-level-1 X: the common row-wise case where each X sequence
        # has length 1
        x = x.index_select(0, x_offsets[:-1].long())
    _set_lod(ctx, "Out", y_offsets)
    return {"Out": x.index_select(0, ids)}


@register_op("sequence_concat")
def _sequence_concat(ctx, ins, attrs):
    # concat along the feature axis with identical lod (common usage)
    _set_lod(ctx, "Out", _offsets(ctx))
    return {"Out": torch.cat(ins["X"], dim=-1)}


@register_op("lod_reset")
def _lod_reset(ctx, ins, attrs):
    x = ins["X"][0]
    if ins.get("Y"):
        y_name = ctx.op.inputs["Y"][0]
        y_off = ctx.env.get(lod_key(y_name))
        if y_off is not None:
            _set_lod(ctx, "Out", y_off)
        else:
            _set_lod(ctx, "Out", _i32(ins["Y"][0].reshape(-1)))
    else:
        host = np.asarray(attrs.get("target_lod"), np.int32)
        _set_lod(ctx, "Out", torch.from_numpy(host.copy()).to(x.device),
                 host=host)
    return {"Out": x}


@register_op("sequence_reshape")
def _sequence_reshape(ctx, ins, attrs):
    x = ins["X"][0]
    new_dim = int(attrs["new_dim"])
    offsets = _offsets(ctx)
    d = x.shape[1]
    out = x.reshape(-1, new_dim)
    scale = d // new_dim if new_dim <= d else None

    def scaled(o):
        return o * scale if scale else o * d // new_dim

    host = ctx.host_lod(offsets)
    _set_lod(ctx, "Out", _i32(scaled(offsets)),
             host=None if host is None else scaled(host).astype(np.int32))
    return {"Out": out}


@register_op("sequence_slice")
def _sequence_slice(ctx, ins, attrs):
    """Per-sequence subrange (operators/sequence_slice_op): keep rows
    [offset_i, offset_i + length_i) of each sequence, compacted to the
    front of the input-size buffer; the tail is zeros."""
    x = ins["X"][0]
    off = ins["Offset"][0].reshape(-1)
    length = ins["Length"][0].reshape(-1)
    offsets = _offsets(ctx)
    total = x.shape[0]
    s = seg_ids(offsets, total)
    rel = torch.arange(total, dtype=offsets.dtype,
                       device=x.device) - offsets[s]
    kept = (rel >= off[s]) & (rel < off[s] + length[s])
    _set_lod(ctx, "Out", _cum_offsets(_i32(length)))
    return {"Out": _compact(x, kept, total)}


@register_op("sequence_erase")
def _sequence_erase(ctx, ins, attrs):
    """Remove listed token values (operators/sequence_erase_op): kept
    tokens compact to the front of the input-size buffer, in order, and
    the output offsets describe the new ragged layout."""
    x = ins["X"][0]
    offsets = _offsets(ctx)
    flat = x.reshape(-1)
    total = flat.shape[0]
    kept = torch.ones((total,), dtype=torch.bool, device=x.device)
    for tok in attrs.get("tokens", []):
        kept = kept & (flat != tok)
    out = _compact(flat, kept, total)
    n = offsets.shape[0] - 1
    kept_per_seq = segment_sum(_i32(kept), seg_ids(offsets, total), n)
    _set_lod(ctx, "Out", _cum_offsets(kept_per_seq))
    return {"Out": out.reshape(x.shape)}


@register_op("sequence_reverse")
def _sequence_reverse(ctx, ins, attrs):
    """Per-sequence time reversal: row p of sequence i moves to
    offsets[i] + (offsets[i+1]-1-p)."""
    x = ins["X"][0]
    offsets = _offsets(ctx)
    total = x.shape[0]
    pos = torch.arange(total, dtype=offsets.dtype, device=x.device)
    ids = seg_ids(offsets, total)
    perm = offsets[ids] + (offsets[ids + 1] - 1 - pos)
    _set_lod(ctx, "Out", offsets)
    return {"Out": x.index_select(0, perm.long())}


def context_window(x, offsets, cl, cs):
    """[total, D] -> [total, cl*D]: row t holds x[t+cs .. t+cs+cl-1],
    zeros beyond its sequence's bounds (the gather half of
    sequence_conv)."""
    total = x.shape[0]
    s = seg_ids(offsets, total)
    pos = torch.arange(total, dtype=offsets.dtype, device=x.device)
    lo, hi = offsets[s], offsets[s + 1]
    cols = []
    for j in range(cl):
        src = pos + cs + j
        valid = ((src >= lo) & (src < hi))[:, None]
        got = x.index_select(0, torch.clamp(src, 0, total - 1).long())
        cols.append(torch.where(valid, got, torch.zeros_like(got)))
    return torch.cat(cols, dim=1)


@register_op("sequence_context")
def _sequence_context(ctx, ins, attrs):
    """Context-window concatenation WITHOUT weights (reference
    ContextProjection)."""
    cl = int(attrs["context_length"])
    cs = int(attrs.get("context_start", -(cl // 2)))
    return {"Out": context_window(ins["X"][0], _offsets(ctx), cl, cs)}


@register_op("kmax_seq_score")
def _kmax_seq_score(ctx, ins, attrs):
    """Per-sequence top-k score indices (reference KmaxSeqScoreLayer):
    the WITHIN-sequence indices of each sequence's beam_size highest
    scores, -1 where the sequence is shorter. One masked top-k over an
    [n, total] view, no loop over sequences."""
    x = ins["X"][0].reshape(-1)
    offsets = _offsets(ctx)
    total = x.shape[0]
    n = offsets.shape[0] - 1
    k = int(attrs.get("beam_size", 1))
    ids = seg_ids(offsets, total)
    rows = torch.arange(n, device=x.device)
    masked = torch.where(ids[None, :] == rows[:, None], x[None, :],
                         torch.full_like(x, float("-inf"))[None, :])
    top_s, top_i = stable_topk(masked, min(k, total))
    rel = _i32(top_i) - offsets[:-1, None]
    rel = torch.where(torch.isfinite(top_s), rel, torch.full_like(rel, -1))
    if k > total:  # more slots than tokens exist at all
        rel = torch.cat([rel, torch.full((n, k - total), -1,
                                         dtype=rel.dtype,
                                         device=x.device)], dim=1)
    return {"Out": rel}


@register_op("sub_nested_seq")
def _sub_nested_seq(ctx, ins, attrs):
    """Select sub-sequences out of a nested (2-level LoD) sequence
    (reference SubNestedSequenceLayer): slot (i, j) of the N*S output
    sequences is sub-sequence selected_indices[i, j] of sequence i, or
    an EMPTY sequence for -1 entries; tokens compact to the front of a
    buffer the size of X."""
    x = ins["X"][0]  # [total, D]
    sel = _i32(ins["S"][0])  # [N, S]
    name = ctx.op.inputs["X"][0]
    tok_off = ctx.env[lod_key(name)]  # [M+1] token offsets per sub-seq
    outer = ctx.env.get(name + LOD_SRC)
    if outer is None:
        raise ValueError(
            "sub_nested_seq input %r is not a nested sequence (feed it "
            "with a 2-level LoD)" % name
        )
    outer = _i32(outer)  # [N+1] sub-seq slots per sequence
    total = x.shape[0]
    M = tok_off.shape[0] - 1
    N, S = sel.shape

    valid = sel >= 0
    gsel = outer[:-1, None] + sel
    g = torch.clamp(gsel, 0, M - 1).long()  # [N,S] global sub-seq id
    # a selected index past the sequence's own sub-seq count is -1
    valid = valid & (gsel < outer[1:, None])
    lengths = torch.where(valid, tok_off[g + 1] - tok_off[g],
                          torch.zeros_like(sel))
    new_off = _cum_offsets(lengths.reshape(-1))  # [N*S+1]
    pos = torch.arange(total, dtype=torch.int32, device=x.device)
    slot = torch.searchsorted(new_off, pos, right=True) - 1
    slot = torch.clamp(slot, 0, N * S - 1)
    src = tok_off[g.reshape(-1)[slot]] + (pos - new_off[slot])
    live = _col(pos < new_off[-1], x.dim())
    got = x.index_select(0, torch.clamp(src, 0, total - 1).long())
    _set_lod(ctx, "Out", new_off)
    return {"Out": torch.where(live, got, torch.zeros_like(got))}


class _LambdaCost(torch.autograd.Function):
    """LambdaRank's NDCG forward with the classic lambda gradient as its
    backward (the JAX package's custom_vjp)."""

    @staticmethod
    def forward(fctx, s, label, ids, same, pos, max_dcg, K, n):
        rank_out = _rank(s, same, pos)
        gain = torch.exp2(label) - 1.0
        contrib = torch.where(rank_out < K, gain * _inv_log(rank_out),
                              torch.zeros_like(gain))
        dcg = segment_sum(contrib, ids, n)
        fctx.save_for_backward(s, label, ids, same, pos, max_dcg)
        return (dcg / max_dcg)[ids][:, None]

    @staticmethod
    def backward(fctx, gbar):
        s, label, ids, same, pos, max_dcg = fctx.saved_tensors
        rank_lbl = _rank(label, same, pos)
        ra = rank_lbl[:, None]
        rb = rank_lbl[None, :]
        upper = same & (ra < rb)  # pair (a, b) with a ranked above b
        dcg_dif = (torch.exp2(label)[:, None] - torch.exp2(label)[None, :]) \
            * (_inv_log(ra) - _inv_log(rb))
        lam = -torch.abs(dcg_dif) / (1.0 + torch.exp(s[:, None]
                                                     - s[None, :]))
        lam = torch.where(upper, lam / max_dcg[ids][:, None],
                          torch.zeros_like(lam))
        g = lam.sum(dim=1) - lam.sum(dim=0)
        return (g * gbar.reshape(-1),) + (None,) * 7


def _rank(v, same, pos):
    """0-based rank of each token within its sequence, descending v
    (ties by position)."""
    gt = (v[None, :] > v[:, None]) | (
        (v[None, :] == v[:, None]) & (pos[None, :] < pos[:, None]))
    return (same & gt).sum(dim=1)


def _inv_log(r):
    return 1.0 / torch.log(r.to(torch.float32) + 2.0)


@register_op("lambda_rank")
def _lambda_rank(ctx, ins, attrs):
    """LambdaRank listwise cost (reference CostLayer.cpp LambdaCost):
    forward emits each sequence's NDCG@K (from the MODEL-score ranking)
    broadcast over the sequence's rows; the backward is the lambda
    gradient, from [T, T] pairwise matrices masked to same-sequence
    pairs. maxSortSize=-1 semantics (full sort) only."""
    out_score = ins["X"][0].reshape(-1)
    label = ins["Score"][0].reshape(-1)
    offsets = _offsets(ctx)
    K = int(attrs.get("NDCG_num", 5))
    total = out_score.shape[0]
    n = offsets.shape[0] - 1
    ids = seg_ids(offsets, total)
    same = ids[:, None] == ids[None, :]
    pos = torch.arange(total, device=out_score.device)
    rank_lbl = _rank(label, same, pos)
    gain = torch.exp2(label) - 1.0
    max_dcg = segment_sum(
        torch.where(rank_lbl < K, gain * _inv_log(rank_lbl),
                    torch.zeros_like(gain)), ids, n)
    max_dcg = torch.clamp(max_dcg, min=1e-12)
    return {"Out": _LambdaCost.apply(out_score, label, ids, same, pos,
                                     max_dcg, K, n)}


@register_op("cross_entropy_over_beam")
def _cross_entropy_over_beam(ctx, ins, attrs):
    """Cross-entropy over beam expansions (reference
    CrossEntropyOverBeam.cpp): each expansion contributes, per outer
    sequence, logsumexp(scores over its candidates) - score[gold];
    expansions are summed into an [N, 1] cost (every expansion counted,
    as in the JAX package)."""
    total_cost = None
    for k, (s, g) in enumerate(zip(ins["Scores"], ins["Gold"])):
        s = s.reshape(-1)
        offsets = ctx.env[lod_key(ctx.op.inputs["Scores"][k])]
        n = offsets.shape[0] - 1
        ids = seg_ids(offsets, s.shape[0])
        m = segment_max(s, ids, n)
        lse = m + torch.log(segment_sum(torch.exp(s - m[ids]), ids, n))
        gold_pos = offsets[:-1] + _i32(g.reshape(-1))
        ce = lse - s[torch.clamp(gold_pos, 0, s.shape[0] - 1).long()]
        total_cost = ce if total_cost is None else total_cost + ce
    return {"Out": total_cost[:, None]}


# ---------------------------------------------------------------------------
# LoD plumbing layer ops (reference layers/control_flow.py lod_rank_table,
# max_sequence_len, reorder_lod_tensor_by_rank, split/merge_lod_tensor) on
# the packed + offsets representation.
# ---------------------------------------------------------------------------


@register_op("lod_rank_table")
def _lod_rank_table(ctx, ins, attrs):
    """Sequences sorted by length descending (stable): rows are
    [original_index, length] (reference lod_rank_table.h RankTable)."""
    lengths = seg_lengths(_offsets(ctx))
    order = torch.sort(-lengths, stable=True).indices
    return {"Out": torch.stack([_i32(order), _i32(lengths[order])], dim=1)}


@register_op("max_sequence_len")
def _max_sequence_len(ctx, ins, attrs):
    table = ins["RankTable"][0]
    return {"Out": table[:, 1].max().reshape((1,)).to(torch.int64)}


@register_op("reorder_lod_tensor_by_rank")
def _reorder_lod_tensor_by_rank(ctx, ins, attrs):
    """Reorder X's sequences into the rank table's order (reference
    reorder_lod_tensor_by_rank_op.cc): a gather on the packed buffer,
    new offsets from the permuted lengths."""
    x = ins["X"][0]
    table = ins["RankTable"][0]
    offsets = _offsets(ctx)
    total = x.shape[0]
    order = table[:, 0].long()
    new_off = _cum_offsets(table[:, 1])
    pos = torch.arange(total, dtype=torch.int32, device=x.device)
    slot = torch.searchsorted(new_off, pos, right=True) - 1
    slot = torch.clamp(slot, 0, order.shape[0] - 1)
    src = offsets[order[slot]] + (pos - new_off[slot])
    _set_lod(ctx, "Out", new_off)
    return {"Out": x.index_select(0, torch.clamp(src, 0, total - 1).long())}


@register_op("split_lod_tensor")
def _split_lod_tensor(ctx, ins, attrs):
    """Route rows by boolean mask into two input-size buffers with valid
    counts (reference split_lod_tensor_op.cc; the IfElse scatter half):
    row order within each branch is the input's, the tail is zeros."""
    x = ins["X"][0]
    mask = ins["Mask"][0].reshape(-1).to(torch.bool)
    n = x.shape[0]
    n_true = _i32(mask.sum())
    zero = torch.zeros((), dtype=torch.int32, device=x.device)
    _set_lod(ctx, "OutTrue", torch.stack([zero, n_true]))
    _set_lod(ctx, "OutFalse", torch.stack([zero, n - n_true]))
    return {"OutTrue": _compact(x, mask, n), "OutFalse": _compact(x, ~mask, n)}


@register_op("merge_lod_tensor")
def _merge_lod_tensor(ctx, ins, attrs):
    """Inverse of split_lod_tensor (reference merge_lod_tensor_op.cc):
    out[i] = InTrue[rank_true[i]] if mask[i] else InFalse[rank_false[i]]."""
    mask = ins["Mask"][0].reshape(-1).to(torch.bool)
    t = ins["InTrue"][0]
    f = ins["InFalse"][0]
    rank_t = torch.clamp(torch.cumsum(mask.to(torch.int64), 0) - 1, min=0)
    rank_f = torch.clamp(torch.cumsum((~mask).to(torch.int64), 0) - 1,
                         min=0)
    sel_t = t.index_select(0, torch.clamp(rank_t, 0, t.shape[0] - 1))
    sel_f = f.index_select(0, torch.clamp(rank_f, 0, f.shape[0] - 1))
    return {"Out": torch.where(_col(mask, t.dim()), sel_t, sel_f)}
