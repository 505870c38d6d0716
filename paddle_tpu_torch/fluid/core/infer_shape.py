"""Build-time shape/dtype propagation.

The reference runs C++ InferShape per op at graph-build time (and again at
runtime, operator.cc:484). Here shapes only matter while *building* the
program — layer functions size parameters off their input shapes — so this
is a small symbolic propagation pass invoked from Block.append_op. -1 marks
the batch (or any unknown) dimension and flows through untouched. Runtime
shapes are the tensors' own.
"""

from __future__ import annotations

import numpy as np

_RULES = {}


def register_infer(op_type):
    def deco(fn):
        _RULES[op_type] = fn
        return fn

    return deco


def infer_op_shapes(op, block) -> None:
    """Set shapes of op's output vars (only where still None)."""
    fn = _RULES.get(op.type, _default_rule)
    try:
        fn(op, block)
    except Exception:
        # shape inference is best-effort: a layer that later *needs* the
        # shape will raise a clear error at that point
        pass


def _var(block, name):
    return block.var(name)


def _shape(block, name):
    return block.var(name).shape


def _set(block, name, shape, dtype=None):
    v = block.var(name)
    if v.shape is None and shape is not None:
        v.shape = tuple(int(s) for s in shape)
    if dtype is not None:
        v.dtype = dtype


def _default_rule(op, block):
    """Out mirrors X (elementwise/activation/optimizer-style ops)."""
    src = None
    for slot in ("X", "Input", "Param", "Logits"):
        if op.inputs.get(slot):
            src = op.inputs[slot][0]
            break
    if src is None:
        return
    shape = _shape(block, src)
    dtype = block.var(src).dtype
    for slot, names in op.outputs.items():
        for n in names:
            if slot in ("Out", "Y", "Output", "ParamOut", "Loss", "Softmax"):
                _set(block, n, shape, dtype)


@register_infer("mul")
def _mul(op, block):
    x = _shape(block, op.inputs["X"][0])
    y = _shape(block, op.inputs["Y"][0])
    xn = op.attrs.get("x_num_col_dims", 1)
    yn = op.attrs.get("y_num_col_dims", 1)
    _set(block, op.outputs["Out"][0], tuple(x[:xn]) + tuple(y[yn:]),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("matmul")
def _matmul(op, block):
    x = list(_shape(block, op.inputs["X"][0]))
    y = list(_shape(block, op.inputs["Y"][0]))
    if op.attrs.get("transpose_X"):
        x[-1], x[-2] = x[-2], x[-1]
    if op.attrs.get("transpose_Y"):
        y[-1], y[-2] = y[-2], y[-1]
    out = list(x[:-1]) + [y[-1]]
    # leading batch dims broadcast: take the longer rank's prefix
    if len(y) > len(x):
        out = list(y[:-2]) + [x[-2], y[-1]]
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)


def _conv_spatial(in_size, k, s, p, d):
    if in_size == -1:
        return -1
    return (in_size + 2 * p - (d * (k - 1) + 1)) // s + 1


@register_infer("conv2d")
def _conv2d(op, block):
    x = _shape(block, op.inputs["Input"][0])
    w = _shape(block, op.inputs["Filter"][0])
    s = op.attrs.get("strides", [1, 1])
    p = op.attrs.get("paddings", [0, 0])
    d = op.attrs.get("dilations", [1, 1])
    out = (
        x[0],
        w[0],
        _conv_spatial(x[2], w[2], s[0], p[0], d[0]),
        _conv_spatial(x[3], w[3], s[1], p[1], d[1]),
    )
    _set(block, op.outputs["Output"][0], out, block.var(op.inputs["Input"][0]).dtype)


register_infer("depthwise_conv2d")(_conv2d)


@register_infer("conv2d_transpose")
def _conv2d_t(op, block):
    x = _shape(block, op.inputs["Input"][0])
    w = _shape(block, op.inputs["Filter"][0])  # IOHW
    s = op.attrs.get("strides", [1, 1])
    p = op.attrs.get("paddings", [0, 0])
    d = op.attrs.get("dilations", [1, 1])
    def up(i, k, st, pd, dl):
        if i == -1:
            return -1
        return (i - 1) * st - 2 * pd + dl * (k - 1) + 1
    out = (x[0], w[1], up(x[2], w[2], s[0], p[0], d[0]), up(x[3], w[3], s[1], p[1], d[1]))
    _set(block, op.outputs["Output"][0], out, block.var(op.inputs["Input"][0]).dtype)


@register_infer("pool2d")
def _pool2d(op, block):
    x = _shape(block, op.inputs["X"][0])
    if op.attrs.get("global_pooling"):
        out = (x[0], x[1], 1, 1)
    else:
        k = op.attrs["ksize"]
        s = op.attrs.get("strides", [1, 1])
        p = op.attrs.get("paddings", [0, 0])

        def _sz(i, kk, ss, pp):
            if i == -1:
                return -1
            if op.attrs.get("ceil_mode"):
                return -(-(i + 2 * pp - kk) // ss) + 1
            return (i + 2 * pp - kk) // ss + 1

        out = (x[0], x[1], _sz(x[2], k[0], s[0], p[0]), _sz(x[3], k[1], s[1], p[1]))
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)


@register_infer("reshape")
def _reshape(op, block):
    x = _shape(block, op.inputs["X"][0])
    shape = [int(s) for s in op.attrs["shape"]]
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = x[i]
    if -1 in shape and -1 not in x and shape.count(-1) == 1:
        known = int(np.prod([s for s in shape if s != -1]))
        total = int(np.prod(x))
        if known > 0 and total > 0 and total % known == 0:
            shape[shape.index(-1)] = total // known
    _set(block, op.outputs["Out"][0], shape, block.var(op.inputs["X"][0]).dtype)


@register_infer("transpose")
def _transpose(op, block):
    x = _shape(block, op.inputs["X"][0])
    perm = op.attrs["axis"]
    _set(block, op.outputs["Out"][0], [x[i] for i in perm],
         block.var(op.inputs["X"][0]).dtype)


@register_infer("concat")
def _concat(op, block):
    xs = [_shape(block, n) for n in op.inputs["X"]]
    axis = op.attrs.get("axis", 0)
    out = list(xs[0])
    if all(x[axis] != -1 for x in xs):
        out[axis] = sum(x[axis] for x in xs)
    else:
        out[axis] = -1
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)


@register_infer("split")
def _split(op, block):
    x = _shape(block, op.inputs["X"][0])
    axis = op.attrs.get("axis", -1)
    sections = op.attrs.get("sections") or []
    num = op.attrs.get("num", 0)
    outs = op.outputs["Out"]
    dtype = block.var(op.inputs["X"][0]).dtype
    if sections:
        for n, s in zip(outs, sections):
            shp = list(x)
            shp[axis] = s
            _set(block, n, shp, dtype)
    else:
        for n in outs:
            shp = list(x)
            shp[axis] = x[axis] // num if x[axis] != -1 else -1
            _set(block, n, shp, dtype)


@register_infer("lookup_table")
def _lookup_table(op, block):
    ids = _shape(block, op.inputs["Ids"][0])
    w = _shape(block, op.inputs["W"][0])
    if ids[-1] == 1:
        out = tuple(ids[:-1]) + (w[1],)
    else:
        out = tuple(ids) + (w[1],)
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["W"][0]).dtype)


@register_infer("cross_entropy")
def _cross_entropy(op, block):
    x = _shape(block, op.inputs["X"][0])
    _set(block, op.outputs["Y"][0], (x[0], 1), block.var(op.inputs["X"][0]).dtype)


@register_infer("softmax_with_cross_entropy")
def _swce(op, block):
    x = _shape(block, op.inputs["Logits"][0])
    dtype = block.var(op.inputs["Logits"][0]).dtype
    _set(block, op.outputs["Loss"][0], (x[0], 1), dtype)
    _set(block, op.outputs["Softmax"][0], x, dtype)


@register_infer("mean")
def _mean(op, block):
    _set(block, op.outputs["Out"][0], (1,), block.var(op.inputs["X"][0]).dtype)


@register_infer("squared_l2_norm")
def _sq_l2(op, block):
    _set(block, op.outputs["Out"][0], (1,), block.var(op.inputs["X"][0]).dtype)


def _reduce_rule(op, block):
    x = _shape(block, op.inputs["X"][0])
    if op.attrs.get("reduce_all"):
        out = (1,) * len(x) if op.attrs.get("keep_dim") else (1,)
    else:
        dim = op.attrs.get("dim", 0)
        dims = tuple(dim) if isinstance(dim, (list, tuple)) else (dim,)
        dims = tuple(d % len(x) for d in dims)
        if op.attrs.get("keep_dim"):
            out = tuple(1 if i in dims else s for i, s in enumerate(x))
        else:
            out = tuple(s for i, s in enumerate(x) if i not in dims)
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)


for _t in ("reduce_sum", "reduce_mean", "reduce_max", "reduce_min", "reduce_prod"):
    register_infer(_t)(_reduce_rule)


@register_infer("top_k")
def _top_k(op, block):
    x = _shape(block, op.inputs["X"][0])
    k = op.attrs.get("k", 1)
    out = tuple(x[:-1]) + (k,)
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)
    _set(block, op.outputs["Indices"][0], out, "int64")


@register_infer("accuracy")
def _accuracy(op, block):
    _set(block, op.outputs["Accuracy"][0], (1,), "float32")
    _set(block, op.outputs["Correct"][0], (1,), "int64")
    _set(block, op.outputs["Total"][0], (1,), "int64")


@register_infer("fill_constant")
def _fill_constant(op, block):
    _set(block, op.outputs["Out"][0], op.attrs["shape"],
         op.attrs.get("dtype", "float32"))


register_infer("uniform_random")(_fill_constant)
register_infer("gaussian_random")(_fill_constant)
register_infer("truncated_gaussian_random")(_fill_constant)
register_infer("assign_value")(_fill_constant)


@register_infer("fill_constant_batch_size_like")
def _fill_bsl(op, block):
    ref = _shape(block, op.inputs["Input"][0])
    shape = [int(s) for s in op.attrs["shape"]]
    shape[op.attrs.get("output_dim_idx", 0)] = ref[op.attrs.get("input_dim_idx", 0)]
    _set(block, op.outputs["Out"][0], shape, op.attrs.get("dtype", "float32"))


@register_infer("cast")
def _cast(op, block):
    _set(block, op.outputs["Out"][0], _shape(block, op.inputs["X"][0]),
         op.attrs["out_dtype"])


@register_infer("one_hot")
def _one_hot(op, block):
    x = _shape(block, op.inputs["X"][0])
    _set(block, op.outputs["Out"][0], (x[0], op.attrs["depth"]), "float32")


@register_infer("sequence_pool")
def _sequence_pool(op, block):
    x = _shape(block, op.inputs["X"][0])
    # packed [T, D] -> [batch, D]; batch unknown at build time
    _set(block, op.outputs["Out"][0], (-1,) + tuple(x[1:]),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("sequence_expand")
def _sequence_expand(op, block):
    x = _shape(block, op.inputs["X"][0])
    _set(block, op.outputs["Out"][0], (-1,) + tuple(x[1:]),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("im2sequence")
def _im2sequence(op, block):
    x = _shape(block, op.inputs["X"][0])
    kh, kw = op.attrs["kernels"]
    _set(block, op.outputs["Out"][0], (-1, x[1] * kh * kw),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("maxout")
def _maxout(op, block):
    x = _shape(block, op.inputs["X"][0])
    g = op.attrs["groups"]
    _set(block, op.outputs["Out"][0], (x[0], x[1] // g, x[2], x[3]),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("expand")
def _expand(op, block):
    x = _shape(block, op.inputs["X"][0])
    times = op.attrs["expand_times"]
    out = tuple(-1 if s == -1 else s * t for s, t in zip(x, times))
    _set(block, op.outputs["Out"][0], out, block.var(op.inputs["X"][0]).dtype)


@register_infer("gather")
def _gather(op, block):
    x = _shape(block, op.inputs["X"][0])
    idx = _shape(block, op.inputs["Index"][0])
    _set(block, op.outputs["Out"][0], (idx[0],) + tuple(x[1:]),
         block.var(op.inputs["X"][0]).dtype)


@register_infer("autodiff")
def _autodiff(op, block):
    pass  # grad var shapes were set by append_backward


def _compare_rule(op, block):
    x = _shape(block, op.inputs["X"][0])
    _set(block, op.outputs["Out"][0], x, "bool")


for _t in ("less_than", "less_equal", "greater_than", "greater_equal",
           "equal", "not_equal"):
    register_infer(_t)(_compare_rule)


def _noop_rule(op, block):
    pass


# control-flow ops manage their own vars; the default mirror rule would
# clobber e.g. a bool condition's dtype
for _t in ("while", "dynamic_rnn", "array_length", "beam_search_decode"):
    register_infer(_t)(_noop_rule)


@register_infer("array_write")
def _array_write_rule(op, block):
    # remember the element shape on the array var so array_read can
    # propagate it (build-time only; values live in the trace env)
    x = block.var(op.inputs["X"][0])
    arr = block.var(op.outputs["Out"][0])
    if getattr(arr, "elem_shape", None) is None and x.shape is not None:
        arr.elem_shape = (-1,) + tuple(x.shape[1:])
        arr.dtype = x.dtype


@register_infer("array_read")
def _array_read_rule(op, block):
    arr = block.var(op.inputs["X"][0])
    shape = getattr(arr, "elem_shape", None)
    if shape is not None:
        _set(block, op.outputs["Out"][0], shape, arr.dtype)


@register_infer("beam_search")
def _beam_search_rule(op, block):
    _set(block, op.outputs["selected_ids"][0], (-1, 1), "int64")
    _set(block, op.outputs["selected_scores"][0], (-1, 1), "float32")
