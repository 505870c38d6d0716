"""Linear-chain CRF kernels: log-likelihood, Viterbi decode, chunk eval
and precision/recall (counterpart of paddle_tpu/fluid/core/kernels_crf.py,
as plain torch ops).

The ragged batch is gathered once into a padded `[B, T, n]` block, with
T the exact longest sequence from the host copy of the offsets
(kernels_rnn._seq_T); the alpha and Viterbi recursions are a Python loop
over time in LOG space, finished sequences carrying their state under
the mask, and the backward pass is the lowering's autograd over that
loop. Nothing inside a loop reads the device back. Ties in the Viterbi
maxima and in the backtrack go to the lowest index (`torch.argmax`, as
`jnp.argmax`). Chunk evaluation is vectorised: begin/end markers and a
running maximum of chunk starts (`torch.cummax`).

Parity: reference operators/linear_chain_crf_op.{h,cc},
operators/crf_decoding_op.h, operators/chunk_eval_op.{h,cc},
operators/precision_recall_op.h.

Transition layout (reference linear_chain_crf_op.h): Transition[0] = start
weights, Transition[1] = end weights, Transition[2:] = [n, n] transition
matrix w[from, to].
"""

from __future__ import annotations

import torch

from .kernels_rnn import _seq_T, packed_to_padded, padded_to_packed
from .kernels_sequence import lod_key, seg_ids, seg_lengths
from .registry import register_op


def _emission_lod(ctx):
    key = lod_key(ctx.op.inputs["Emission"][0])
    if key not in ctx.env:
        raise ValueError("%s needs a LoD (ragged) Emission input"
                         % ctx.op.type)
    return ctx.env[key]


def _padded(ctx, em, offsets):
    """(em [B, T, n] padded, the same time-major [T, B, n], mask [T, B]
    bool, T)."""
    T = _seq_T(ctx, em.shape[0], offsets)
    em_p, mask = packed_to_padded(em, offsets, T)
    return em_p, em_p.transpose(0, 1), mask.transpose(0, 1), T


def _read(ctx, slot):
    return any(ctx.is_read(n) for n in ctx.op.outputs.get(slot, ()))


@register_op("linear_chain_crf")
def _linear_chain_crf(ctx, ins, attrs):
    em = ins["Emission"][0]  # [total, n] packed
    tr = ins["Transition"][0]  # [n+2, n]
    label = ins["Label"][0].reshape(-1).long()  # [total]
    offsets = _emission_lod(ctx)
    B = offsets.shape[0] - 1
    a, b, w = tr[0], tr[1], tr[2:]
    em_p, em_t, mask_t, T = _padded(ctx, em, offsets)
    lab_p, _ = packed_to_padded(label, offsets, T)  # [B, T]
    lab_t = lab_p.transpose(0, 1)  # [T, B]
    lens = seg_lengths(offsets).long()

    # log partition: the alpha recursion (logsumexp over the 'from' axis)
    alpha = a[None, :] + em_t[0]  # [B, n]
    alphas = [alpha]
    for t in range(1, T):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) \
            + em_t[t]
        alphas.append(alpha)  # the JAX scan's ys: the carry before t
        alpha = torch.where(mask_t[t][:, None], nxt, alpha)
    log_z = torch.logsumexp(alpha + b[None, :], dim=1)  # [B]

    # the gold path's score
    m = mask_t.to(em.dtype)
    em_score = (torch.gather(em_t, 2, lab_t[:, :, None])[:, :, 0] * m).sum(0)
    trans_score = (w[lab_t[:-1], lab_t[1:]] * m[1:]).sum(0)
    y_last = lab_p[torch.arange(B, device=em.device),
                   torch.clamp_min(lens - 1, 0)]
    gold = em_score + trans_score + a[lab_t[0]] + b[y_last]

    out = {"LogLikelihood": (log_z - gold).reshape(B, 1)}
    # Alpha and the *Exps outputs exist for the reference's API (its grad
    # kernel reads them); computed only when something reads them
    if _read(ctx, "Alpha"):
        out["Alpha"] = torch.stack(alphas)
    if _read(ctx, "EmissionExps"):
        out["EmissionExps"] = torch.exp(em_p)
    if _read(ctx, "TransitionExps"):
        out["TransitionExps"] = torch.exp(tr)
    return out


@register_op("crf_decoding")
def _crf_decoding(ctx, ins, attrs):
    em = ins["Emission"][0]  # [total, n]
    tr = ins["Transition"][0]
    offsets = _emission_lod(ctx)
    total, n = em.shape
    B = offsets.shape[0] - 1
    a, b, w = tr[0], tr[1], tr[2:]
    _, em_t, mask_t, T = _padded(ctx, em, offsets)
    lens = seg_lengths(offsets).long()
    bidx = torch.arange(B, device=em.device)

    delta = a[None, :] + em_t[0]
    deltas, bps = [delta], []
    for t in range(1, T):
        scores = delta[:, :, None] + w[None, :, :]  # [B, from, to]
        best = scores.max(dim=1).values + em_t[t]
        bps.append(torch.argmax(scores, dim=1))  # [B, n]: first maximum
        delta = torch.where(mask_t[t][:, None], best, delta)
        deltas.append(delta)

    # backtrack: bps[t] points INTO step t from step t+1
    cur = torch.zeros(B, dtype=torch.long, device=em.device)
    path = [None] * T
    for t in range(T - 1, -1, -1):
        cand_end = torch.argmax(deltas[t] + b[None, :], dim=1)
        cand_in = bps[t][bidx, cur] if t < T - 1 else cur
        cur = torch.where(lens - 1 == t, cand_end,
                          torch.where(t < lens - 1, cand_in, cur))
        path[t] = cur
    path = padded_to_packed(torch.stack(path, dim=1), offsets, total)

    ctx.set_lod(ctx.op.outputs["ViterbiPath"][0], offsets)
    if ctx.op.inputs.get("Label"):
        # with a Label input the output flips to per-token correctness
        # (reference crf_decoding_op.h:54-62)
        path = (ins["Label"][0].reshape(-1).long() == path).long()
    return {"ViterbiPath": path.reshape(total, 1)}


# ---------------------------------------------------------------------------
# chunk_eval — operators/chunk_eval_op (IOB/IOE/IOBES/plain schemes)
# ---------------------------------------------------------------------------


def _shift(v, fill, forward):
    """v shifted one position later (forward) or earlier, `fill` at the
    vacated end."""
    pad = torch.full((1,), fill, dtype=v.dtype, device=v.device)
    return torch.cat([pad, v[:-1]]) if forward else torch.cat([v[1:], pad])


def _chunk_markers(labels, first, last, scheme, num_types, ntag, excluded):
    """(begin, end, type) per position."""
    in_range = labels < num_types * ntag
    typ = torch.where(in_range, labels // ntag, torch.full_like(labels,
                                                                num_types))
    tag = torch.where(in_range, labels % ntag, torch.full_like(labels, -1))
    in_chunk = in_range
    for e in excluded or ():
        in_chunk = in_chunk & (typ != int(e))

    prev_in = _shift(in_chunk, False, True) & ~first
    prev_typ = _shift(typ, -1, True)
    next_in = _shift(in_chunk, False, False) & ~last
    next_typ = _shift(typ, -1, False)
    new_run = ~prev_in | (prev_typ != typ)
    run_ends = ~next_in | (next_typ != typ)

    if scheme == "IOB":  # tag 0 = B, 1 = I
        begin = (tag == 0) | new_run
        end = run_ends | _shift(tag == 0, False, False)
    elif scheme == "IOE":  # tag 0 = I, 1 = E
        begin = new_run | _shift(tag == 1, False, True)
        end = (tag == 1) | run_ends
    elif scheme == "IOBES":  # 0=B, 1=I, 2=E, 3=S
        begin = (tag == 0) | (tag == 3) | new_run
        end = (tag == 2) | (tag == 3) | run_ends
    elif scheme == "plain":
        begin, end = new_run, run_ends
    else:
        raise ValueError("unknown chunk scheme %r" % scheme)
    return begin & in_chunk, end & in_chunk, typ


def _chunk_start_index(begin):
    """Running chunk-start position per token (valid inside a chunk):
    chunks are contiguous, so the latest begin <= i is i's chunk start."""
    idx = torch.arange(begin.shape[0], device=begin.device)
    return torch.cummax(torch.where(begin, idx, torch.full_like(idx, -1)),
                        0).values


@register_op("chunk_eval")
def _chunk_eval(ctx, ins, attrs):
    infer = ins["Inference"][0].reshape(-1).long()
    label = ins["Label"][0].reshape(-1).long()
    offsets = ctx.env[lod_key(ctx.op.inputs["Label"][0])]
    total = label.shape[0]
    scheme = attrs["chunk_scheme"]
    num_types = int(attrs["num_chunk_types"])
    excluded = attrs.get("excluded_chunk_types") or []
    ntag = {"IOB": 2, "IOE": 2, "IOBES": 4, "plain": 1}[scheme]

    seg = seg_ids(offsets, total)
    idx = torch.arange(total, dtype=offsets.dtype, device=label.device)
    first = idx == offsets[seg]
    last = idx == (offsets[seg + 1] - 1)

    lb, le, lt = _chunk_markers(label, first, last, scheme, num_types, ntag,
                                excluded)
    ib, ie, it = _chunk_markers(infer, first, last, scheme, num_types, ntag,
                                excluded)
    correct = le & ie & (_chunk_start_index(lb) == _chunk_start_index(ib)) \
        & (lt == it)
    num_label = lb.sum()
    num_infer = ib.sum()
    num_correct = correct.sum()

    nc = num_correct.float()
    precision = nc / torch.clamp_min(num_infer, 1).float()
    recall = nc / torch.clamp_min(num_label, 1).float()
    f1 = torch.where(num_correct > 0, 2 * precision * recall
                     / torch.clamp_min(precision + recall, 1e-12),
                     torch.zeros_like(precision))
    return {
        "Precision": precision.reshape(1),
        "Recall": recall.reshape(1),
        "F1-Score": f1.reshape(1),
        "NumInferChunks": num_infer.reshape(1),
        "NumLabelChunks": num_label.reshape(1),
        "NumCorrectChunks": num_correct.reshape(1),
    }


def _class_sum(v, ids, C):
    """jax.ops.segment_sum(v, ids, C): ids outside [0, C) add nothing."""
    ok = (ids >= 0) & (ids < C)
    return torch.zeros(C, dtype=v.dtype, device=v.device).index_add(
        0, torch.where(ok, ids, torch.zeros_like(ids)),
        torch.where(ok, v, torch.zeros_like(v)))


@register_op("precision_recall")
def _precision_recall(ctx, ins, attrs):
    """Multi-class precision/recall/F1, batch + accumulated (reference
    operators/precision_recall_op.h: per-class TP/FP/FN states, macro and
    micro averages over 6 metric slots)."""
    idx = ins["Indices"][0].reshape(-1).long()  # predicted class
    labels = ins["Labels"][0].reshape(-1).long()
    C = int(attrs["class_number"])
    weights = ins["Weights"][0].reshape(-1).float() if ins.get("Weights") \
        else torch.ones(idx.shape[0], device=idx.device)
    states_in = ins["StatesInfo"][0] if ins.get("StatesInfo") \
        else torch.zeros((C, 4), device=idx.device)

    correct = (idx == labels).float() * weights
    tp = _class_sum(correct, labels, C)
    fp = _class_sum(weights, idx, C) - tp
    fn = _class_sum(weights, labels, C) - tp
    tn = weights.sum() - tp - fp - fn
    batch_states = torch.stack([tp, fp, tn, fn], dim=1)  # [C, 4]
    sp = ctx.spmd and (ctx.spmd.input_split(ctx, "Indices")
                       or ctx.spmd.input_split(ctx, "Labels"))
    if sp:  # the global batch's counts: one sum over the ranks
        batch_states = ctx.spmd.all_reduce(batch_states, sp.all_axes)

    def metrics(states):
        tp_, fp_, fn_ = states[:, 0], states[:, 1], states[:, 3]
        prec = tp_ / torch.clamp_min(tp_ + fp_, 1e-12)
        rec = tp_ / torch.clamp_min(tp_ + fn_, 1e-12)
        f1 = 2 * prec * rec / torch.clamp_min(prec + rec, 1e-12)
        stp, sfp, sfn = tp_.sum(), fp_.sum(), fn_.sum()
        mp = stp / torch.clamp_min(stp + sfp, 1e-12)
        mr = stp / torch.clamp_min(stp + sfn, 1e-12)
        mf = 2 * mp * mr / torch.clamp_min(mp + mr, 1e-12)
        return torch.stack([prec.mean(), rec.mean(), f1.mean(), mp, mr, mf])

    accum_states = states_in + batch_states
    return {
        "BatchMetrics": metrics(batch_states),
        "AccumMetrics": metrics(accum_states),
        "AccumStatesInfo": accum_states,
    }
