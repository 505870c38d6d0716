"""Recurrent-network kernels: dynamic LSTM/GRU over ragged batches
(counterpart of paddle_tpu/fluid/core/kernels_rnn.py, as plain torch ops).

The packed batch is gathered once into a padded `[batch, T, ...]` block
(T from the host: the exact longest sequence, kernels_rnn._seq_T), the
recurrence is a Python loop over time-major slices — each step one dense
GEMM over the whole batch (`torch.addmm`) and the cell's elementwise ops —
and the result is scattered back to the packed layout. Finished
sequences carry their state forward under a mask, the reference's
"shrinking active batch" without dynamic shapes; the steps before the
shortest sequence ends need no mask when the host knows the offsets.
The lowering's single `torch.autograd.grad` differentiates the loop.
Nothing inside the time loop reads the device back: no `.item()`, no
`nonzero`, no host copy.

Parity targets: operators/lstm_op.{cc,h}, operators/gru_op.{cc,h},
operators/lstm_unit_op, operators/gru_unit_op, operators/sequence_conv_op,
operators/lstmp_op.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels_sequence import context_window, lod_key, seg_ids, seg_lengths
from .registry import register_op

_ACTS = {
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "relu": torch.relu,
    "identity": lambda x: x,
    "linear": lambda x: x,
}


def _act(name):
    return _ACTS[name]


def _seq_T(ctx, total, offsets=None):
    """Time extent of a padded recurrence, from the host. Preference
    order (the JAX package's):

    1. `offsets` whose host copy is known (fed, or static in the graph,
       as the uniform LoD im2sequence emits): their exact longest
       sequence. A graph-produced LoD may be longer than any fed one, and
       must not be cut to the fed maximum;
    2. the longest FED sequence of the run (ctx.seq_maxlen);
    3. the packed total (right for any batch, just wasteful)."""
    host = None if offsets is None else ctx.host_lod(offsets)
    if host is not None:
        d = np.diff(host)
        if d.size and int(d.max()) > 0:
            return int(d.max())
    return int(ctx.seq_maxlen) if ctx.seq_maxlen else int(total)


def _full_steps(ctx, offsets):
    """The number of leading time steps every sequence takes part in
    (the shortest length), when the host knows the offsets; else 0."""
    host = ctx.host_lod(offsets)
    if host is None or host.shape[0] < 2:
        return 0
    return int(np.diff(host).min())


def packed_to_padded(x, offsets, T, reverse=False):
    """[total, ...] packed -> ([n, T, ...] padded, [n, T] bool mask).

    With reverse=True each sequence is time-flipped into the padded
    block (so a forward loop implements the reference's is_reverse)."""
    lens = seg_lengths(offsets)  # [n]
    n = lens.shape[0]
    t = torch.arange(T, dtype=offsets.dtype, device=x.device)
    if reverse:
        rel = lens[:, None] - 1 - t[None, :]
        mask = rel >= 0
    else:
        rel = t[None, :].expand(n, T)
        mask = t[None, :] < lens[:, None]
    idx = offsets[:-1, None] + torch.clamp(rel, min=0)
    idx = torch.clamp(idx, 0, x.shape[0] - 1).reshape(-1).long()
    return x.index_select(0, idx).reshape((n, T) + tuple(x.shape[1:])), mask


def padded_to_packed(h, offsets, total, reverse=False):
    """[n, T, ...] padded -> [total, ...] packed (inverse of the above)."""
    T = h.shape[1]
    s = seg_ids(offsets, total)  # [total]
    t = torch.arange(total, dtype=offsets.dtype, device=h.device) \
        - offsets[s]
    if reverse:
        t = seg_lengths(offsets)[s] - 1 - t
    flat = h.reshape((-1,) + tuple(h.shape[2:]))
    return flat.index_select(0, s * T + torch.clamp(t, 0, T - 1).long())


def _time_major(x, offsets, T, reverse):
    """Packed -> (padded [T, n, ...] time-major, [T, n, 1] bool mask)."""
    xp, mask = packed_to_padded(x, offsets, T, reverse=reverse)
    return xp.transpose(0, 1), mask.transpose(0, 1)[..., None]


def _peepholes(bias, H, peephole):
    if peephole and bias is not None:
        return (bias[0, 4 * H:5 * H], bias[0, 5 * H:6 * H],
                bias[0, 6 * H:7 * H])
    return None, None, None


def _lstm_cell(g, c, w_ic, w_fc, w_oc, gate_act, cell_act, cand_act):
    """One LSTM cell from its gate pre-activations g = [i, f, c~, o]."""
    gi, gf, gc, go = g.chunk(4, dim=1)
    if w_ic is not None:
        gi = gi + c * w_ic
        gf = gf + c * w_fc
    i = gate_act(gi)
    f = gate_act(gf)
    c_new = f * c + i * cand_act(gc)
    if w_oc is not None:
        go = go + c_new * w_oc
    return gate_act(go) * cell_act(c_new), c_new


# ---------------------------------------------------------------------------
# dynamic_lstm — operators/lstm_op.h LSTMKernel; gate layout [i, f, c̃, o]
# ---------------------------------------------------------------------------


@register_op("lstm")
def _lstm(ctx, ins, attrs):
    x = ins["Input"][0]           # [total, 4H] (pre-projected by the fc)
    w = ins["Weight"][0]          # [H, 4H] recurrent weight
    bias = ins["Bias"][0] if ins.get("Bias") else None  # [1, 4H] or [1, 7H]
    offsets = ctx.env[lod_key(ctx.op.inputs["Input"][0])]
    n = offsets.shape[0] - 1
    H = w.shape[0]
    total = x.shape[0]
    reverse = bool(attrs.get("is_reverse", False))
    acts = (_act(attrs.get("gate_activation", "sigmoid")),
            _act(attrs.get("cell_activation", "tanh")),
            _act(attrs.get("candidate_activation", "tanh")))
    if bias is not None:
        x = x + bias[:, :4 * H]
    peep = _peepholes(bias, H, bool(attrs.get("use_peepholes", True)))

    T = _seq_T(ctx, total, offsets)
    full = _full_steps(ctx, offsets)
    xp, mask = _time_major(x, offsets, T, reverse)  # [T, n, 4H], [T, n, 1]
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((n, H))
    c = ins["C0"][0] if ins.get("C0") else x.new_zeros((n, H))
    hs, cs = [], []
    for t in range(T):
        h_new, c_new = _lstm_cell(torch.addmm(xp[t], h, w), c, *peep, *acts)
        if t >= full:
            h_new = torch.where(mask[t], h_new, h)
            c_new = torch.where(mask[t], c_new, c)
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    hidden = padded_to_packed(torch.stack(hs, 1), offsets, total, reverse)
    cell = padded_to_packed(torch.stack(cs, 1), offsets, total, reverse)
    return {"Hidden": hidden, "Cell": cell}


# ---------------------------------------------------------------------------
# dynamic_gru — operators/gru_op.h; weight [H, 3H]: [:, :2H]=update|reset,
# [:, 2H:]=candidate. h' = (1-u)*h + u*c̃ (reference gru_compute convention,
# operators/math/detail/gru_kernel.h:62, gru_unit_op.cc:122).
# ---------------------------------------------------------------------------


def _gru_cell(xt, h, w_ur, w_c, gate_act, cand_act):
    H = h.shape[1]
    ur = gate_act(torch.addmm(xt[:, :2 * H], h, w_ur))
    u, r = ur[:, :H], ur[:, H:]
    reset_h = r * h
    c = cand_act(torch.addmm(xt[:, 2 * H:], reset_h, w_c))
    return (1.0 - u) * h + u * c, u, r, c, reset_h


@register_op("gru")
def _gru(ctx, ins, attrs):
    x = ins["Input"][0]            # [total, 3H]
    w = ins["Weight"][0]           # [H, 3H]
    bias = ins["Bias"][0] if ins.get("Bias") else None  # [1, 3H]
    offsets = ctx.env[lod_key(ctx.op.inputs["Input"][0])]
    n = offsets.shape[0] - 1
    H = w.shape[0]
    total = x.shape[0]
    reverse = bool(attrs.get("is_reverse", False))
    gate_act = _act(attrs.get("gate_activation", "sigmoid"))
    cand_act = _act(attrs.get("activation", "tanh"))
    if bias is not None:
        x = x + bias
    w_ur, w_c = w[:, :2 * H], w[:, 2 * H:]

    T = _seq_T(ctx, total, offsets)
    full = _full_steps(ctx, offsets)
    xp, mask = _time_major(x, offsets, T, reverse)
    h = ins["H0"][0] if ins.get("H0") else x.new_zeros((n, H))
    hs = []
    for t in range(T):
        h_new = _gru_cell(xp[t], h, w_ur, w_c, gate_act, cand_act)[0]
        h = h_new if t < full else torch.where(mask[t], h_new, h)
        hs.append(h)
    hidden = padded_to_packed(torch.stack(hs, 1), offsets, total, reverse)
    return {"Hidden": hidden}


# ---------------------------------------------------------------------------
# single-step cells (operators/lstm_unit_op.cc, gru_unit_op.cc) — dense,
# used by DynamicRNN-style user loops
# ---------------------------------------------------------------------------


@register_op("lstm_unit")
def _lstm_unit(ctx, ins, attrs):
    x = ins["X"][0]          # [n, 4H] pre-activations
    c_prev = ins["C_prev"][0]
    forget_bias = float(attrs.get("forget_bias", 0.0))
    gi, gf, gc, go = x.chunk(4, dim=1)
    c = torch.sigmoid(gf + forget_bias) * c_prev \
        + torch.sigmoid(gi) * torch.tanh(gc)
    h = torch.sigmoid(go) * torch.tanh(c)
    return {"C": c, "H": h}


@register_op("gru_unit")
def _gru_unit(ctx, ins, attrs):
    x = ins["Input"][0]              # [n, 3H]
    h_prev = ins["HiddenPrev"][0]    # [n, H]
    w = ins["Weight"][0]             # [H, 3H]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    H = h_prev.shape[-1]
    if bias is not None:
        x = x + bias
    h, u, r, c, reset_h = _gru_cell(
        x, h_prev, w[:, :2 * H], w[:, 2 * H:],
        _act(attrs.get("gate_activation", "sigmoid")),
        _act(attrs.get("activation", "tanh")))
    return {"Gate": torch.cat([u, r, c], dim=1), "ResetHiddenPrev": reset_h,
            "Hidden": h}


# ---------------------------------------------------------------------------
# sequence_conv — operators/sequence_conv_op; context window gather + GEMM
# ---------------------------------------------------------------------------


@register_op("sequence_conv")
def _sequence_conv(ctx, ins, attrs):
    x = ins["X"][0]              # [total, D]
    filt = ins["Filter"][0]      # [context_length * D, M]
    offsets = ctx.env[lod_key(ctx.op.inputs["X"][0])]
    cl = int(attrs.get("contextLength", attrs.get("context_length", 3)))
    cs = int(attrs.get("contextStart", attrs.get("context_start",
                                                 -(cl // 2))))
    return {"Out": context_window(x, offsets, cl, cs) @ filt}


@register_op("lstmp")
def _lstmp(ctx, ins, attrs):
    """LSTM with recurrent projection (reference operators/lstmp_op.h):
    the recurrence runs on the PROJECTED state r = proj_act(h @ W_proj)
    [P wide], so the recurrent GEMM is [P, 4H]. Outputs the projection
    sequence and the cell sequence."""
    x = ins["Input"][0]            # [total, 4H]
    w = ins["Weight"][0]           # [P, 4H] recurrent weight over r
    w_proj = ins["ProjWeight"][0]  # [H, P]
    bias = ins["Bias"][0] if ins.get("Bias") else None
    offsets = ctx.env[lod_key(ctx.op.inputs["Input"][0])]
    n = offsets.shape[0] - 1
    H, P = w_proj.shape
    total = x.shape[0]
    reverse = bool(attrs.get("is_reverse", False))
    acts = (_act(attrs.get("gate_activation", "sigmoid")),
            _act(attrs.get("cell_activation", "tanh")),
            _act(attrs.get("candidate_activation", "tanh")))
    proj_act = _act(attrs.get("proj_activation", "tanh"))
    if bias is not None:
        x = x + bias[:, :4 * H]
    peep = _peepholes(bias, H, bool(attrs.get("use_peepholes", True)))

    T = _seq_T(ctx, total, offsets)
    full = _full_steps(ctx, offsets)
    xp, mask = _time_major(x, offsets, T, reverse)
    r = x.new_zeros((n, P))
    c = x.new_zeros((n, H))
    rs, cs = [], []
    for t in range(T):
        h_new, c_new = _lstm_cell(torch.addmm(xp[t], r, w), c, *peep, *acts)
        r_new = proj_act(h_new @ w_proj)
        if t >= full:
            r_new = torch.where(mask[t], r_new, r)
            c_new = torch.where(mask[t], c_new, c)
        r, c = r_new, c_new
        rs.append(r)
        cs.append(c)
    proj = padded_to_packed(torch.stack(rs, 1), offsets, total, reverse)
    cell = padded_to_packed(torch.stack(cs, 1), offsets, total, reverse)
    ctx.set_lod(ctx.op.outputs["Projection"][0], offsets)
    ctx.set_lod(ctx.op.outputs["Cell"][0], offsets)
    return {"Projection": proj, "Cell": cell}
