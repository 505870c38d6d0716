"""CTC loss, edit distance and CTC greedy alignment (counterpart of
paddle_tpu/fluid/core/kernels_ctc.py, as plain torch ops).

CTC is the log-space alpha recursion over the extended
(blank-interleaved) label sequence, vectorised over the padded batch and
looped over time in f32; the loss trains through the lowering's autograd
like any other op. `WarpCTCGrad` (the per-frame gradient the reference's
library hands back beside the loss) costs a second pass, so it is
computed only when the run reads it. Edit distance is the Levenshtein DP
looped over the hypothesis axis, each row one prefix-min over the
reference axis.
"""

from __future__ import annotations

import torch

from .kernels_rnn import _seq_T, packed_to_padded
from .kernels_sequence import _compact, _cum_offsets, _offsets, seg_ids, \
    seg_lengths, segment_sum
from .registry import register_op

_NEG = -1e30


def _lse3(a, b, c):
    """log(exp(a) + exp(b) + exp(c)) with _NEG as log 0 (the JAX
    package's guarded form, term for term)."""
    m = torch.maximum(torch.maximum(a, b), c)
    safe = torch.where(m <= _NEG, torch.zeros_like(m), m)

    def term(v):
        return torch.exp(torch.where(v <= _NEG, torch.full_like(v, _NEG),
                                     v - safe))

    return safe + torch.log(term(a) + term(b) + term(c) + 1e-45)


def _shift(a, k):
    return torch.cat([torch.full_like(a[:, :k], _NEG), a[:, :-k]], dim=1)


def _ctc_loss(logits_packed, t_off, T, t_lens, lab_at, l_lens, s_valid,
              can_skip, blank, norm_by_times):
    """Per-sequence negative log-likelihood [B] of the padded labels."""
    B, S = lab_at.shape
    logit_p, _ = packed_to_padded(logits_packed, t_off, T)  # [B,T,C]
    logp = torch.log_softmax(logit_p.float(), dim=-1)
    neg = torch.full((B, 1), _NEG, device=logp.device)

    def emit(t):
        # log p of emitting z_s at time t: [B,S]
        return torch.gather(logp[:, t], 1, lab_at)

    a1 = torch.where((l_lens > 0)[:, None], emit(0)[:, 1:2], neg)
    a0 = torch.cat([logp[:, 0, blank:blank + 1], a1,
                    torch.full((B, S - 2), _NEG, device=logp.device)], 1)
    alpha = torch.where(s_valid, a0, torch.full_like(a0, _NEG))
    for t in range(1, T):
        skip = torch.where(can_skip, _shift(alpha, 2),
                           torch.full_like(alpha, _NEG))
        new = _lse3(alpha, _shift(alpha, 1), skip) + emit(t)
        new = torch.where(s_valid, new, torch.full_like(new, _NEG))
        alpha = torch.where((t < t_lens)[:, None], new, alpha)

    send = (2 * l_lens).long()[:, None]  # index of the final blank
    last_blank = torch.gather(alpha, 1, send)[:, 0]
    last_lab = torch.where(
        l_lens > 0,
        torch.gather(alpha, 1, torch.clamp(send - 1, min=0))[:, 0],
        torch.full_like(last_blank, _NEG))
    m = torch.maximum(last_blank, last_lab)
    safe = torch.where(m <= _NEG, torch.zeros_like(m), m)
    ll = safe + torch.log(
        torch.exp(last_blank - safe)
        + torch.exp(torch.where(last_lab <= _NEG,
                                torch.full_like(last_lab, _NEG),
                                last_lab - safe))
        + 1e-45)
    loss = -ll
    if norm_by_times:
        loss = loss / torch.clamp(t_lens.to(loss.dtype), min=1.0)
    return loss


@register_op("warpctc")
def _warpctc(ctx, ins, attrs):
    """Inputs: Logits packed [total_t, C] (pre-softmax, lod over time),
    Label packed [total_l, 1] (lod over label length). Output: Loss
    [n_seq, 1], and WarpCTCGrad = d(sum loss)/d logits where the run
    reads it. attrs: blank (default 0), norm_by_times."""
    logits = ins["Logits"][0]
    labels = ins["Label"][0].reshape(-1)
    t_off = _offsets(ctx, "Logits")
    l_off = _offsets(ctx, "Label")
    blank = int(attrs.get("blank", 0))
    B = t_off.shape[0] - 1
    dev = logits.device

    # each input pads to its own longest sequence (so short CTC labels
    # don't pad to the frame length)
    T = _seq_T(ctx, logits.shape[0], t_off)
    t_lens = seg_lengths(t_off)
    lab_p, _ = packed_to_padded(labels, l_off,
                                _seq_T(ctx, labels.shape[0], l_off))
    Lmax = lab_p.shape[1]
    l_lens = seg_lengths(l_off)

    # extended sequence: blank z1 blank z2 ... blank  (S = 2L+1)
    S = 2 * Lmax + 1
    s_idx = torch.arange(S, device=dev)
    is_lab = (s_idx % 2) == 1
    lab_at = torch.where(
        is_lab[None, :],
        lab_p[:, torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                             0, Lmax - 1)],
        torch.full((1, S), blank, dtype=lab_p.dtype, device=dev)).long()
    s_valid = s_idx[None, :] < (2 * l_lens[:, None] + 1)  # [B,S]
    # skip transition allowed where z_s is a label differing from z_{s-2}
    prev2 = torch.cat([torch.full((B, 2), blank, dtype=lab_at.dtype,
                                  device=dev), lab_at[:, :-2]], dim=1)
    can_skip = is_lab[None, :] & (lab_at != prev2)
    args = (t_off, T, t_lens, lab_at, l_lens, s_valid, can_skip, blank,
            bool(attrs.get("norm_by_times")))

    loss = _ctc_loss(logits, *args)
    out = {"Loss": loss.reshape(B, 1).to(logits.dtype)}
    grad_name = ctx.op.outputs.get("WarpCTCGrad", [None])[0]
    if grad_name is not None and ctx.is_read(grad_name):
        lg = logits.detach().float().requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(_ctc_loss(lg, *args).sum(), lg)
        out["WarpCTCGrad"] = grad.to(logits.dtype)
    return out


@register_op("edit_distance")
def _edit_distance(ctx, ins, attrs):
    """Levenshtein distance per (Hyps_i, Refs_i) sequence pair (reference
    operators/edit_distance_op.h). Output [n_seq, 1] float; attr
    `normalized` divides by the reference length."""
    hyp = ins["Hyps"][0].reshape(-1)
    ref = ins["Refs"][0].reshape(-1)
    h_off = _offsets(ctx, "Hyps")
    r_off = _offsets(ctx, "Refs")
    B = h_off.shape[0] - 1
    dev = hyp.device

    Hm = _seq_T(ctx, hyp.shape[0], h_off)
    Rm = _seq_T(ctx, ref.shape[0], r_off)
    hyp_p, _ = packed_to_padded(hyp, h_off, Hm)  # [B,Hm]
    ref_p, _ = packed_to_padded(ref, r_off, Rm)  # [B,Rm]
    h_lens = seg_lengths(h_off)
    r_lens = seg_lengths(r_off)

    j = torch.arange(Rm + 1, dtype=torch.float32, device=dev)
    row = j.expand(B, Rm + 1)  # distance from the empty hypothesis
    for i in range(1, Hm + 1):
        # row = D[i-1, :]; D[i, j] = min(sub_j, del_j, D[i, j-1] + 1)
        # with D[i, 0] = i: a prefix min of (a_k - k), plus j
        cost_sub = (hyp_p[:, i - 1][:, None] != ref_p).float()  # [B,Rm]
        a = torch.cat([row[:, :1] + 1.0,
                       torch.minimum(row[:, :-1] + cost_sub,
                                     row[:, 1:] + 1.0)], dim=1)
        new = torch.cummin(a - j, dim=1).values + j
        # rows beyond the hyp length keep the previous value
        row = torch.where((i <= h_lens)[:, None], new, row)
    dist = torch.gather(row, 1, torch.clamp(r_lens, 0, Rm).long()[:, None])
    if attrs.get("normalized"):
        dist = dist / torch.clamp(r_lens.float(), min=1.0)[:, None]
    return {"Out": dist.reshape(B, 1).float(),
            "SequenceNum": torch.full((1,), B, dtype=torch.int64,
                                      device=dev)}


@register_op("ctc_align")
def _ctc_align(ctx, ins, attrs):
    """CTC greedy (best-path) decode (reference ctc_align_op.cc +
    ctc_greedy_decoder nn.py): per sequence take the argmax token per
    step, collapse repeats, drop blanks; kept tokens compact to the
    front of the input-size buffer and the output offsets describe
    them."""
    x = ins["Input"][0]  # [total, C] probs/logits OR [total] token ids
    offsets = _offsets(ctx, "Input")
    blank = int(attrs.get("blank", 0))
    total = x.shape[0]
    ids = x.reshape(total, -1)
    tokens = (torch.argmax(ids, dim=1) if ids.shape[1] > 1
              else ids[:, 0]).to(torch.int32)
    seg = seg_ids(offsets, total)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=x.device),
                       (tokens[1:] != tokens[:-1]) | (seg[1:] != seg[:-1])])
    kept = first & (tokens != blank)
    out = _compact(tokens, kept, total)
    kept_per_seq = segment_sum(kept.to(torch.int32), seg,
                               offsets.shape[0] - 1)
    ctx.set_lod(ctx.op.outputs["Output"][0], _cum_offsets(kept_per_seq))
    return {"Output": out.reshape(total, 1)}
