"""Tensor / data-movement op kernels: fills, random init, reshape family,
concat/split, embedding lookup, one-hot, gather/scatter (counterpart of
paddle_tpu/fluid/core/kernels_tensor.py, as plain torch ops).

Random ops draw from the port's threefry (utils/prng.py) with the JAX
package's key schedule: `uniform_random` gives the JAX package's bits
exactly; `gaussian_random` / `truncated_gaussian_random` pass the same
uniform bits through torch's erfinv (within a few ulp of XLA's).
`row_conv` and `im2sequence` read and write LoD side-bands
(kernels_sequence.py).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...utils import prng
from .kernels_sequence import lod_key, seg_ids
from .registry import register_op, torch_dtype


def _dtype(attrs, default="float32"):
    return torch_dtype(attrs.get("dtype", default))


@register_op("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    # a loop counter or limit stays on the host (kernels_control.host_names)
    device = torch.device("cpu") if ctx.op.outputs["Out"][0] in \
        ctx.host_names else ctx.device
    return {"Out": torch.full(shape, attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=device)}


@register_op("fill_constant_batch_size_like")
def _fill_constant_bsl(ctx, ins, attrs):
    ref = ins["Input"][0]
    shape = [int(s) for s in attrs["shape"]]
    shape[attrs.get("output_dim_idx", 0)] = ref.shape[
        attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=ref.device)}


@register_op("fill_zeros_like")
def _fill_zeros_like(ctx, ins, attrs):
    return {"Out": torch.zeros_like(ins["X"][0])}


@register_op("uniform_random")
def _uniform_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    # a nonzero `seed` attr pins the draw (reference uniform_random_op
    # seed semantics); seed=0 means "use the executor's RNG stream"
    seed = int(attrs.get("seed", 0) or 0)
    key = prng.PRNGKey(seed, ctx.device) if seed else ctx.next_key()
    out = prng.uniform(key, shape, attrs.get("min", -1.0),
                       attrs.get("max", 1.0))
    return {"Out": out.to(_dtype(attrs))}


@register_op("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    z = prng.normal(ctx.next_key(), shape)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": out.to(_dtype(attrs))}


@register_op("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    shape = tuple(int(s) for s in attrs["shape"])
    z = prng.truncated_normal(ctx.next_key(), -2.0, 2.0, shape)
    out = attrs.get("mean", 0.0) + attrs.get("std", 1.0) * z
    return {"Out": out.to(_dtype(attrs))}


@register_op("assign")
def _assign(ctx, ins, attrs):
    return {"Out": ins["X"][0]}


@register_op("assign_value")
def _assign_value(ctx, ins, attrs):
    vals = torch.tensor(np.asarray(attrs["values"]), dtype=_dtype(attrs),
                        device=ctx.device)
    return {"Out": vals.reshape(tuple(attrs["shape"]))}


@register_op("shape")
def _shape(ctx, ins, attrs):
    x = ins["Input"][0]
    return {"Out": torch.tensor(tuple(x.shape), dtype=torch.int32,
                                device=x.device)}


@register_op("concat")
def _concat(ctx, ins, attrs):
    return {"Out": torch.cat(ins["X"], dim=attrs.get("axis", 0))}


@register_op("split")
def _split(ctx, ins, attrs):
    x = ins["X"][0]
    axis = attrs.get("axis", -1)
    sections = attrs.get("sections", [])
    if sections:
        outs = torch.split(x, list(sections), dim=axis)
    else:
        num = attrs.get("num", 0)
        outs = torch.split(x, x.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register_op("reshape")
def _reshape(ctx, ins, attrs):
    x = ins["X"][0]
    shape = [int(s) for s in attrs["shape"]]
    # reference reshape_op: 0 means "copy this dim from input", -1 infers
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x.shape[i]
    return {"Out": x.reshape(tuple(shape))}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs):
    x = ins["X"][0]
    axes = attrs.get("axes", [])
    return {"Out": torch.squeeze(x, dim=tuple(axes)) if axes
            else torch.squeeze(x)}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs):
    x = ins["X"][0]
    nd = x.dim() + len(attrs["axes"])
    for a in sorted(a % nd for a in attrs["axes"]):
        x = x.unsqueeze(a)
    return {"Out": x}


@register_op("transpose")
def _transpose(ctx, ins, attrs):
    return {"Out": ins["X"][0].permute(*attrs["axis"])}


@register_op("expand")
def _expand(ctx, ins, attrs):
    return {"Out": ins["X"][0].repeat(*attrs["expand_times"])}


@register_op("slice")
def _slice(ctx, ins, attrs):
    x = ins["Input"][0]
    idx = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        idx[ax] = slice(st, en)
    return {"Out": x[tuple(idx)]}


@register_op("pad")
def _pad(ctx, ins, attrs):
    x = ins["X"][0]
    p = attrs["paddings"]  # flat [before0, after0, before1, after1, ...]
    pads = []
    for i in reversed(range(x.dim())):
        pads += [p[2 * i], p[2 * i + 1]]
    return {"Out": F.pad(x, pads, value=attrs.get("pad_value", 0.0))}


@register_op("crop")
def _crop(ctx, ins, attrs):
    x = ins["X"][0]
    offsets = attrs.get("offsets")
    shape = attrs.get("shape")
    if ins.get("Y"):
        shape = ins["Y"][0].shape
    # -1 keeps the full remaining extent of that axis (dynamic batch dim)
    idx = tuple(slice(o, None) if s == -1 else slice(o, o + s)
                for o, s in zip(offsets, shape))
    return {"Out": x[idx]}


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """Embedding gather (reference operators/lookup_table_op.cc). Ids come
    in as [N, 1] int; padding_idx rows read as zeros.

    Sparse-gradient sites (lowering._find_sparse_sites): the table is
    read as a constant (it is no autograd leaf), and the gathered rows
    carry the site's zero gradient leaf instead, so the backward pass
    produces a [n_ids, dim] gradient, the SelectedRows value block,
    rather than a dense [vocab, dim] one (reference lookup_table_op.cc
    SelectedRows grad branch). The leaf's dtype is the region's (bf16
    under AMP: the rows are cast after the gather, never the table).
    The touched row ids are recorded under `<out>@sparse_rows`; a
    padding position records the sentinel `height`."""
    w = ins["W"][0]
    ids = ins["Ids"][0]
    flat = ids.reshape(-1).long()
    padding_idx = attrs.get("padding_idx", -1)
    has_pad = padding_idx is not None and padding_idx >= 0
    out_name = ctx.op.outputs["Out"][0]
    leaf_name = ctx.sparse_sites.get(out_name)
    spmd = ctx.spmd
    if spmd is not None:
        spmd.mark(out_name, spmd.input_split(ctx, "Ids"))
        wsp = spmd.input_split(ctx, "W")
        if wsp is not None:
            out = _sharded_lookup(ctx, w, flat, wsp, leaf_name, out_name,
                                  padding_idx if has_pad else None)
            return {"Out": out.reshape(_lookup_shape(ids, w))}
    if leaf_name is not None:
        leaf = ctx.env[leaf_name]
        out = w[flat].to(leaf.dtype) + leaf
        ctx.env[out_name + "@sparse_rows"] = (
            torch.where(flat == padding_idx, w.shape[0], flat)
            if has_pad else flat)
    else:
        out = w[flat]
    if has_pad:
        # masking AFTER the leaf's add zeroes its gradient at padding
        # positions too
        out = torch.where((flat == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    return {"Out": out.reshape(_lookup_shape(ids, w))}


def _lookup_shape(ids, w):
    lead = tuple(ids.shape[:-1]) if ids.shape[-1] == 1 else tuple(ids.shape)
    return lead + (w.shape[1],)


def _sharded_lookup(ctx, w, flat, wsp, leaf_name, out_name, padding_idx):
    """Lookup in a table split along its rows over `wsp.axes`
    (parallel/embedding.py sharded_lookup): this rank gathers the ids in
    its row range, zero rows for the rest, and the sum over the axes
    gives every row once. A sparse site's leaf is added before the sum,
    masked, so its gradient holds exactly the rows this rank owns, and
    the site's rows are local row numbers with the sentinel `height`
    (this shard's row count) for the others."""
    from ...parallel.embedding import local_rows

    local, owned = local_rows(flat, w.shape[0],
                              ctx.spmd.index(wsp.axes))
    rows = w[local]
    if leaf_name is not None:
        leaf = ctx.env[leaf_name]
        rows = rows.to(leaf.dtype) + leaf
        keep = owned if padding_idx is None else owned & (
            flat != padding_idx)
        ctx.env[out_name + "@sparse_rows"] = torch.where(
            keep, local, w.shape[0])
    rows = torch.where(owned[:, None], rows, torch.zeros_like(rows))
    out = ctx.spmd.all_reduce(rows, wsp.axes)
    if padding_idx is not None:
        out = torch.where((flat == padding_idx)[:, None],
                          torch.zeros_like(out), out)
    return out


@register_op("one_hot")
def _one_hot(ctx, ins, attrs):
    ids = ins["X"][0].reshape(-1).long()
    return {"Out": F.one_hot(ids, attrs["depth"]).to(torch.float32)}


@register_op("gather")
def _gather(ctx, ins, attrs):
    return {"Out": ins["X"][0][ins["Index"][0].reshape(-1).long()]}


@register_op("scatter")
def _scatter(ctx, ins, attrs):
    x = ins["X"][0]
    idx = ins["Ids"][0].reshape(-1).long()
    return {"Out": x.index_put((idx,), ins["Updates"][0])}


@register_op("sequence_mask")
def _sequence_mask(ctx, ins, attrs):
    lengths = ins["X"][0].reshape(-1)
    maxlen = attrs.get("maxlen", -1)
    if maxlen is None or maxlen < 0:
        raise ValueError("sequence_mask requires a static maxlen attr")
    mask = torch.arange(maxlen, device=lengths.device)[None, :] \
        < lengths[:, None]
    return {"Y": mask.to(torch_dtype(attrs.get("out_dtype", "int64")))}


@register_op("range")
def _range(ctx, ins, attrs):
    return {"Out": torch.arange(attrs["start"], attrs["end"],
                                attrs.get("step", 1), device=ctx.device
                                ).to(_dtype(attrs, "int32"))}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs):
    index = ins["Ids"][0].reshape(-1).long()
    stacked = torch.stack(ins["X"], dim=0)  # [num_candidates, N, D]
    rows = torch.arange(stacked.shape[1], device=stacked.device)
    return {"Out": stacked[index, rows]}


@register_op("sampling_id")
def _sampling_id(ctx, ins, attrs):
    """Sample one class id per row from a probability distribution
    (reference sampling_id_op.cc), through the ported categorical."""
    p = ins["X"][0]
    logits = torch.log(torch.clamp_min(p.float(), 1e-20))
    # on a mesh, this rank's rows of the draw over the global batch
    sp = ctx.spmd and ctx.spmd.input_split(ctx, "X")
    ids = prng.categorical(ctx.next_key(), logits, offset=ctx.spmd
                           .global_draw(p.shape, sp)[1] if sp else 0)
    return {"Out": ids.to(torch.int32)}


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs):
    """Bilinear image resize on NCHW with the reference's ALIGN-CORNERS
    ratios ((in-1)/(out-1)) (reference bilinear_interp_op.cc)."""
    x = ins["X"][0]
    oh, ow = int(attrs["out_h"]), int(attrs["out_w"])
    h, w = x.shape[2], x.shape[3]

    def axis_coords(out_n, in_n):
        if out_n == 1 or in_n == 1:
            return torch.zeros(out_n, dtype=torch.float32, device=x.device)
        ratio = (in_n - 1) / (out_n - 1)
        return torch.arange(out_n, dtype=torch.float32,
                            device=x.device) * ratio

    ys, xs = axis_coords(oh, h), axis_coords(ow, w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]
    top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
    bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
    return {"Out": top * (1 - wy) + bot * wy}


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs):
    """Circular convolution (reference conv_shift_op.cc): out[i, j] =
    sum_k x[i, (j + k - M//2) mod N] * y[i, k]."""
    x, y = ins["X"][0], ins["Y"][0]
    half = y.shape[1] // 2
    return {"Out": sum(torch.roll(x, shifts=half - k, dims=1) * y[:, k:k + 1]
                       for k in range(y.shape[1]))}


@register_op("reverse")
def _reverse(ctx, ins, attrs):
    """Flip along the given axes (reference reverse_op)."""
    return {"Out": torch.flip(ins["X"][0], tuple(attrs["axis"]))}


@register_op("scale_sub_region")
def _scale_sub_region(ctx, ins, attrs):
    """Scale values inside a per-sample 1-based inclusive (channel,
    height, width) box [c0, c1, h0, h1, w0, w1] (reference
    ScaleSubRegionLayer.cpp)."""
    x = ins["X"][0]  # [N, C, H, W]
    idx = ins["Indices"][0].long()  # [N, 6]
    value = float(attrs.get("value", 1.0))
    _, C, H, W = x.shape

    def band(n, lo, hi):
        r = torch.arange(n, device=x.device)[None, :]
        return (r >= idx[:, lo:lo + 1] - 1) & (r <= idx[:, hi:hi + 1] - 1)

    mask = (band(C, 0, 1)[:, :, None, None] & band(H, 2, 3)[:, None, :, None]
            & band(W, 4, 5)[:, None, None, :])
    return {"Out": torch.where(mask, x * value, x)}


@register_op("select")
def _select(ctx, ins, attrs):
    """Scalar-condition select: Out = X if Cond else Y."""
    cond = ins["Cond"][0].reshape(()).to(torch.bool)
    return {"Out": torch.where(cond, ins["X"][0], ins["Y"][0])}


@register_op("is_empty")
def _is_empty(ctx, ins, attrs):
    """Out = [numel(X) == 0] (reference operators/is_empty_op.cc)."""
    return {"Out": torch.tensor([ins["X"][0].numel() == 0],
                                device=ctx.device)}


@register_op("row_conv")
def _row_conv(ctx, ins, attrs):
    """Lookahead row convolution (reference operators/row_conv_op.cc);
    each step mixes `future_context` future frames of the same sequence.
    Accepts the packed LoD layout [T, D] (masked at sequence boundaries
    via segment ids) or a dense [N, T, D] batch."""
    x = ins["X"][0]
    filt = ins["Filter"][0]  # [future_context+1, D]
    out = torch.zeros_like(x)
    if x.dim() == 2:
        offsets = ctx.env.get(lod_key(ctx.op.inputs["X"][0]))
        total = x.shape[0]
        ids = (seg_ids(offsets, total) if offsets is not None
               else torch.zeros((total,), dtype=torch.int64,
                                device=x.device))  # one long sequence
        for k in range(filt.shape[0]):
            shifted = F.pad(x[k:], (0, 0, 0, k))
            ids_k = F.pad(ids[k:], (0, k), value=-1)
            valid = (ids_k == ids)[:, None]
            out = out + torch.where(valid, shifted * filt[k][None, :],
                                    torch.zeros_like(shifted))
        return {"Out": out}
    for k in range(filt.shape[0]):
        out = out + F.pad(x[:, k:, :], (0, 0, 0, k)) * filt[k][None, None, :]
    return {"Out": out}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs):
    """Reference operators/im2sequence_op.cc: sliding blocks -> rows, in
    the channel-major (c, kh, kw) feature order of the JAX package's
    conv_general_dilated_patches. Each image becomes one sequence of
    oh*ow steps; the offsets are static in the graph, so their host copy
    is known (kernels_rnn._seq_T takes a recurrence's extent from it)."""
    x = ins["X"][0]  # NCHW
    kh, kw = attrs.get("kernels", [1, 1])
    sh, sw = attrs.get("strides", [1, 1])
    pads = attrs.get("paddings", [0, 0, 0, 0])
    x = F.pad(x, (pads[1], pads[3], pads[0], pads[2]))
    n, c, h, w = x.shape
    steps = ((h - kh) // sh + 1) * ((w - kw) // sw + 1)
    patches = F.unfold(x, (kh, kw), stride=(sh, sw))  # [N, C*kh*kw, L]
    out = patches.transpose(1, 2).reshape(n * steps, c * kh * kw)
    host = np.arange(n + 1, dtype=np.int32) * steps
    ctx.set_lod(ctx.op.outputs["Out"][0],
                torch.arange(n + 1, dtype=torch.int32, device=x.device)
                * steps, host=host)
    return {"Out": out}
