"""Neural-network layer functions.

API parity with reference python/paddle/v2/fluid/layers/nn.py (fc:72,
embedding:193, conv2d:1136, pool2d:1432, batch_norm:1481, dropout:851,
cross_entropy:897, accuracy:1020, sequence_* family, matmul:2386, ...).
Each function appends ops to the default main program (a copy of the
JAX package's builders); the executor runs the ops on its device. A
layer whose op has no ported kernel yet builds, and raises when run.
"""

from __future__ import annotations

import numpy as np

from ..core.program import Variable
from ..initializer import Constant, Normal, Xavier
from ..layer_helper import LayerHelper
from ..param_attr import ParamAttr
from . import tensor as tensor_layers

__all__ = [
    "fc",
    "embedding",
    "sampling_id",
    "bilinear_interp",
    "conv_shift",
    "sequence_context",
    "slice",
    "equal",
    "conv2d",
    "conv2d_transpose",
    "pool2d",
    "batch_norm",
    "layer_norm",
    "dropout",
    "cross_entropy",
    "square_error_cost",
    "accuracy",
    "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits",
    "smooth_l1",
    "chunk_eval",
    "linear_chain_crf",
    "crf_decoding",
    "warpctc",
    "edit_distance",
    "nce",
    "hsigmoid",
    "sequence_erase",
    "precision_recall",
    "auc",
    "topk",
    "matmul",
    "reduce_sum",
    "reduce_mean",
    "reduce_max",
    "reduce_min",
    "reduce_prod",
    "split",
    "l2_normalize",
    "transpose",
    "reshape",
    "lrn",
    "cos_sim",
    "dropout",
    "one_hot",
    "dynamic_lstm",
    "dynamic_gru",
    "lstm_unit",
    "gru_unit",
    "sequence_conv",
    "sequence_pool",
    "sequence_first_step",
    "sequence_last_step",
    "sequence_softmax",
    "sequence_expand",
    "sequence_reshape",
    "sequence_slice",
    "reverse",
    "im2sequence",
    "flash_attention",
    "row_conv",
    "multiplex",
    "maxout",
    "expand",
    "pad",
    "gather",
]


def fc(
    input,
    size,
    num_flatten_dims=1,
    param_attr=None,
    bias_attr=None,
    use_mkldnn=False,
    act=None,
    is_test=False,
    name=None,
    **kwargs,
):
    """Fully connected (reference layers/nn.py:72): per-input weight mul,
    summed, plus bias, then activation."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()

    mul_results = []
    for input_var, param_attr in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        param_shape = [
            int(np.prod(input_shape[num_flatten_dims:])),
            size,
        ]
        w = helper.create_parameter(
            attr=param_attr, shape=param_shape, dtype=dtype, is_bias=False
        )
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(
            type="mul",
            inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": num_flatten_dims, "y_num_col_dims": 1},
        )
        mul_results.append(tmp)

    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(
            type="sum", inputs={"X": mul_results}, outputs={"Out": [pre_bias]}
        )
    pre_activation = helper.append_bias_op(pre_bias, dim_start=num_flatten_dims)
    return helper.append_activation(pre_activation)


def embedding(
    input,
    size,
    is_sparse=False,
    padding_idx=None,
    param_attr=None,
    dtype="float32",
    **kwargs,
):
    """Lookup-table layer (reference nn.py:193).

    `is_sparse=True` selects the SelectedRows sparse-gradient path
    (reference framework/selected_rows.h + the SelectedRows branches of
    sgd/adagrad/adam ops): the backward produces a (rows, values) pair
    sized by the batch's lookup count, and the optimizer applies a
    row-scatter update — work proportional to touched rows, not vocab
    size. The sparse path engages when the table is read only by sparse
    lookups over fed ids and its gradient feeds a sparse-capable
    optimizer (sgd/momentum/adagrad/adam, no regularizer/clip on this
    param); otherwise lowering falls back to the exact dense gradient
    (core/lowering.py:_find_sparse_sites). Moment-tracking optimizers
    update touched rows lazily, matching the reference's sparse
    branches."""
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(
        attr=helper.param_attr, shape=size, dtype=dtype, is_bias=False
    )
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = -1 if padding_idx is None else (
        padding_idx if padding_idx >= 0 else size[0] + padding_idx
    )
    helper.append_op(
        type="lookup_table",
        inputs={"Ids": [input], "W": [w]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "padding_idx": padding_idx},
    )
    return tmp


def conv2d(
    input,
    num_filters,
    filter_size,
    stride=1,
    padding=0,
    dilation=1,
    groups=None,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    use_mkldnn=False,
    act=None,
    name=None,
    **kwargs,
):
    """2-D convolution, NCHW (reference nn.py:1136). use_cudnn/use_mkldnn
    are accepted and ignored: the op runs through cuDNN on the card."""
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1
    if num_channels % groups != 0:
        raise ValueError("num_channels must be divisible by groups")

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    filter_size = _pair(filter_size)
    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)

    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    w = helper.create_parameter(
        attr=helper.param_attr,
        shape=filter_shape,
        dtype=dtype,
        default_initializer=Normal(0.0, std, 0),
    )
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={
            "strides": stride,
            "paddings": padding,
            "dilations": dilation,
            "groups": groups,
        },
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def conv2d_transpose(
    input,
    num_filters,
    output_size=None,
    filter_size=None,
    padding=0,
    stride=1,
    dilation=1,
    param_attr=None,
    bias_attr=None,
    use_cudnn=True,
    act=None,
    name=None,
    **kwargs,
):
    helper = LayerHelper("conv2d_transpose", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    stride = _pair(stride)
    padding = _pair(padding)
    dilation = _pair(dilation)
    if filter_size is None:
        if output_size is None:
            raise ValueError("filter_size or output_size must be given")
        output_size = _pair(output_size)
        h_in, w_in = input.shape[2], input.shape[3]
        filter_size = [
            (output_size[0] - (h_in - 1) * stride[0] + 2 * padding[0] - 1) // dilation[0] + 1,
            (output_size[1] - (w_in - 1) * stride[1] + 2 * padding[1] - 1) // dilation[1] + 1,
        ]
    else:
        filter_size = _pair(filter_size)

    filter_shape = [num_channels, num_filters] + filter_size  # IOHW
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype
    )
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d_transpose",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding, "dilations": dilation},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(
    input,
    pool_size=-1,
    pool_type="max",
    pool_stride=1,
    pool_padding=0,
    global_pooling=False,
    use_cudnn=True,
    ceil_mode=False,
    use_mkldnn=False,
    name=None,
    **kwargs,
):
    if pool_type not in ["max", "avg"]:
        raise ValueError("pool_type must be 'max' or 'avg', got %r" % pool_type)
    if not global_pooling:
        sizes = pool_size if isinstance(pool_size, (list, tuple)) else [pool_size]
        if any(s <= 0 for s in sizes):
            raise ValueError(
                "pool_size must be positive unless global_pooling=True, got %r"
                % (pool_size,)
            )
    helper = LayerHelper("pool2d", **locals())
    dtype = helper.input_dtype()
    out = helper.create_tmp_variable(dtype)

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    helper.append_op(
        type="pool2d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _pair(pool_size),
            "global_pooling": global_pooling,
            "strides": _pair(pool_stride),
            "paddings": _pair(pool_padding),
            "ceil_mode": ceil_mode,
        },
    )
    return out


def batch_norm(
    input,
    act=None,
    is_test=False,
    momentum=0.9,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    data_layout="NCHW",
    in_place=False,
    use_mkldnn=False,
    name=None,
    moving_mean_name=None,
    moving_variance_name=None,
    **kwargs,
):
    """Batch normalization (reference nn.py:1481). Running mean/variance are
    persistable non-trainable vars updated in the same step."""
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    if data_layout == "NCHW":
        channel_num = input_shape[1]
    else:
        channel_num = input_shape[-1]
    param_shape = [channel_num]

    scale = helper.create_parameter(
        attr=helper.param_attr,
        shape=param_shape,
        dtype=dtype,
        default_initializer=Constant(1.0),
    )
    bias = helper.create_parameter(
        attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
    )

    mean = helper.create_global_variable(
        name=moving_mean_name,
        dtype=dtype,
        shape=param_shape,
        persistable=True,
    )
    helper.set_variable_initializer(mean, Constant(0.0))
    variance = helper.create_global_variable(
        name=moving_variance_name,
        dtype=dtype,
        shape=param_shape,
        persistable=True,
    )
    helper.set_variable_initializer(variance, Constant(1.0))

    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)

    helper.append_op(
        type="batch_norm",
        inputs={
            "X": [input],
            "Scale": [scale],
            "Bias": [bias],
            "Mean": [mean],
            "Variance": [variance],
        },
        outputs={
            "Y": [out],
            "MeanOut": [mean],
            "VarianceOut": [variance],
            "SavedMean": [saved_mean],
            "SavedVariance": [saved_variance],
        },
        attrs={
            "momentum": momentum,
            "epsilon": epsilon,
            "is_test": is_test,
            "data_layout": data_layout,
        },
    )
    return helper.append_activation(out)


def layer_norm(
    input,
    scale=True,
    shift=True,
    begin_norm_axis=1,
    epsilon=1e-05,
    param_attr=None,
    bias_attr=None,
    act=None,
    name=None,
    **kwargs,
):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    param_shape = [int(np.prod(input_shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr,
            shape=param_shape,
            dtype=dtype,
            default_initializer=Constant(1.0),
        )
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr, shape=param_shape, dtype=dtype, is_bias=True
        )
        inputs["Bias"] = [b]
    mean_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="layer_norm",
        inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [variance_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis},
    )
    return helper.append_activation(out)


def dropout(x, dropout_prob, is_test=False, seed=None, **kwargs):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    mask = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout",
        inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test, "seed": seed or 0},
    )
    return out


def cross_entropy(input, label, **kwargs):
    helper = LayerHelper("cross_entropy", **kwargs)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="cross_entropy",
        inputs={"X": [input], "Label": [label]},
        outputs={"Y": [out]},
        attrs={"soft_label": kwargs.get("soft_label", False)},
    )
    return out


def square_error_cost(input, label, **kwargs):
    helper = LayerHelper("square_error_cost", **kwargs)
    minus_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="elementwise_sub",
        inputs={"X": [input], "Y": [label]},
        outputs={"Out": [minus_out]},
    )
    square_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="square", inputs={"X": [minus_out]}, outputs={"Out": [square_out]}
    )
    return square_out


def softmax_with_cross_entropy(logits, label, soft_label=False, **kwargs):
    helper = LayerHelper("softmax_with_cross_entropy", **kwargs)
    softmax = helper.create_tmp_variable(dtype=logits.dtype)
    loss = helper.create_tmp_variable(dtype=logits.dtype)
    helper.append_op(
        type="softmax_with_cross_entropy",
        inputs={"Logits": [logits], "Label": [label]},
        outputs={"Softmax": [softmax], "Loss": [loss]},
        attrs={"soft_label": soft_label},
    )
    return loss


def sigmoid_cross_entropy_with_logits(x, label, **kwargs):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="sigmoid_cross_entropy_with_logits",
        inputs={"X": [x], "Label": [label]},
        outputs={"Out": [out]},
    )
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None, **kwargs):
    helper = LayerHelper("smooth_l1", **kwargs)
    diff = helper.create_tmp_variable(dtype=x.dtype)
    loss = helper.create_tmp_variable(dtype=x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(
        type="smooth_l1_loss",
        inputs=inputs,
        outputs={"Diff": [diff], "Out": [loss]},
        attrs={"sigma": sigma or 1.0},
    )
    return loss


def accuracy(input, label, k=1, correct=None, total=None, **kwargs):
    """Top-k accuracy (reference nn.py:1020): top_k + accuracy ops."""
    helper = LayerHelper("accuracy", **kwargs)
    topk_out = helper.create_tmp_variable(dtype=input.dtype)
    topk_indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [topk_out], "Indices": [topk_indices]},
        attrs={"k": k},
    )
    acc_out = helper.create_tmp_variable(dtype="float32")
    if correct is None:
        correct = helper.create_tmp_variable(dtype="int64")
    if total is None:
        total = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices], "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct], "Total": [total]},
    )
    return acc_out


def auc(input, label, curve="ROC", num_thresholds=200, **kwargs):
    helper = LayerHelper("auc", **kwargs)
    auc_out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="auc",
        inputs={"Out": [input], "Label": [label]},
        outputs={"AUC": [auc_out]},
        attrs={"curve": curve, "num_thresholds": num_thresholds},
    )
    return auc_out


def chunk_eval(input, label, chunk_scheme, num_chunk_types, excluded_chunk_types=None, **kwargs):
    """Chunk-level precision/recall/F1 (reference layers/nn.py chunk_eval ->
    operators/chunk_eval_op; vectorised kernel in core/kernels_crf.py)."""
    helper = LayerHelper("chunk_eval", **kwargs)
    precision = helper.create_tmp_variable(dtype="float32")
    recall = helper.create_tmp_variable(dtype="float32")
    f1_score = helper.create_tmp_variable(dtype="float32")
    num_infer = helper.create_tmp_variable(dtype="int64")
    num_label = helper.create_tmp_variable(dtype="int64")
    num_correct = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={
            "Precision": [precision],
            "Recall": [recall],
            "F1-Score": [f1_score],
            "NumInferChunks": [num_infer],
            "NumLabelChunks": [num_label],
            "NumCorrectChunks": [num_correct],
        },
        attrs={
            "chunk_scheme": chunk_scheme,
            "num_chunk_types": num_chunk_types,
            "excluded_chunk_types": excluded_chunk_types or [],
        },
    )
    return precision, recall, f1_score, num_infer, num_label, num_correct


def linear_chain_crf(input, label, param_attr=None):
    """CRF negative log-likelihood over a ragged batch (reference
    layers/nn.py linear_chain_crf -> operators/linear_chain_crf_op).
    Transition parameter is [size+2, size]: start row, end row, then the
    [size, size] transition matrix."""
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[1]
    transition = helper.create_parameter(
        attr=helper.param_attr, shape=[size + 2, size], dtype=helper.input_dtype()
    )
    alpha = helper.create_tmp_variable(dtype=helper.input_dtype())
    emission_exps = helper.create_tmp_variable(dtype=helper.input_dtype())
    transition_exps = helper.create_tmp_variable(dtype=helper.input_dtype())
    log_likelihood = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition], "Label": [label]},
        outputs={
            "Alpha": [alpha],
            "EmissionExps": [emission_exps],
            "TransitionExps": [transition_exps],
            "LogLikelihood": [log_likelihood],
        },
    )
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with the trained CRF transitions (reference
    layers/nn.py crf_decoding -> operators/crf_decoding_op). With `label`,
    returns per-token correctness instead of the path."""
    helper = LayerHelper("crf_decoding", **locals())
    transition = helper.get_parameter(param_attr.name)
    viterbi_path = helper.create_tmp_variable(dtype="int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(
        type="crf_decoding",
        inputs=inputs,
        outputs={"ViterbiPath": [viterbi_path]},
    )
    return viterbi_path


def topk(input, k, **kwargs):
    helper = LayerHelper("top_k", **kwargs)
    values = helper.create_tmp_variable(dtype=input.dtype)
    indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="top_k",
        inputs={"X": [input]},
        outputs={"Out": [values], "Indices": [indices]},
        attrs={"k": k},
    )
    return values, indices


def matmul(x, y, transpose_x=False, transpose_y=False, name=None, **kwargs):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="matmul",
        inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
        attrs={"transpose_X": transpose_x, "transpose_Y": transpose_y},
    )
    return out


def _reduce(op_type, input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    attrs = {"keep_dim": keep_dim}
    if dim is None:
        attrs["reduce_all"] = True
        attrs["dim"] = 0
    else:
        attrs["reduce_all"] = False
        attrs["dim"] = dim
    helper.append_op(
        type=op_type, inputs={"X": [input]}, outputs={"Out": [out]}, attrs=attrs
    )
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(dtype=input.dtype) for _ in range(num)]
    helper.append_op(
        type="split", inputs={"X": [input]}, outputs={"Out": outs}, attrs=attrs
    )
    return outs


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    norm = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="l2_normalize",
        inputs={"X": [x]},
        outputs={"Out": [out], "Norm": [norm]},
        attrs={"axis": axis, "epsilon": epsilon},
    )
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="transpose",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"axis": list(perm)},
    )
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="reshape",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"shape": list(shape)},
    )
    return helper.append_activation(out)


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    mid = helper.create_tmp_variable(dtype=input.dtype, stop_gradient=True)
    helper.append_op(
        type="lrn",
        inputs={"X": [input]},
        outputs={"Out": [out], "MidOut": [mid]},
        attrs={"n": n, "k": k, "alpha": alpha, "beta": beta},
    )
    return out


def cos_sim(X, Y, **kwargs):
    helper = LayerHelper("cos_sim", **kwargs)
    out = helper.create_tmp_variable(dtype=X.dtype)
    xnorm = helper.create_tmp_variable(dtype=X.dtype)
    ynorm = helper.create_tmp_variable(dtype=X.dtype)
    helper.append_op(
        type="cos_sim",
        inputs={"X": [X], "Y": [Y]},
        outputs={"Out": [out], "XNorm": [xnorm], "YNorm": [ynorm]},
    )
    return out


def one_hot(input, depth, **kwargs):
    helper = LayerHelper("one_hot", **kwargs)
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="one_hot",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"depth": depth},
    )
    return out


# --- sequence layers ----------------------------------------------------

def dynamic_lstm(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    use_peepholes=True,
    is_reverse=False,
    gate_activation="sigmoid",
    cell_activation="tanh",
    candidate_activation="tanh",
    dtype="float32",
    name=None,
    **kwargs,
):
    """LSTM over a ragged batch (reference nn.py:252 dynamic_lstm,
    operators/lstm_op). `size` is 4*hidden (paddle convention); `input`
    must already be the 4H-wide projection (an fc ahead of this layer).
    Returns (hidden, cell), both LoD-shaped like the input."""
    helper = LayerHelper("dynamic_lstm", name=name, **kwargs)
    hidden_size = size // 4
    weight = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr),
        shape=[hidden_size, 4 * hidden_size],
        dtype=dtype,
    )
    bias_size = [1, 7 * hidden_size] if use_peepholes else [1, 4 * hidden_size]
    bias = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr),
        shape=bias_size,
        dtype=dtype,
        is_bias=True,
    )
    hidden = helper.create_tmp_variable(dtype, shape=(-1, hidden_size), lod_level=1)
    cell = helper.create_tmp_variable(dtype, shape=(-1, hidden_size), lod_level=1)
    helper.append_op(
        type="lstm",
        inputs={"Input": [input], "Weight": [weight], "Bias": [bias]},
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes,
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
        },
    )
    return hidden, cell


def dynamic_gru(
    input,
    size,
    param_attr=None,
    bias_attr=None,
    is_reverse=False,
    gate_activation="sigmoid",
    candidate_activation="tanh",
    h_0=None,
    dtype="float32",
    **kwargs,
):
    """GRU over a ragged batch (reference nn.py dynamic_gru, operators/
    gru_op). `size` is the hidden width; `input` must be the 3H-wide
    projection. Returns the LoD-shaped hidden sequence."""
    helper = LayerHelper("dynamic_gru", **kwargs)
    weight = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[size, 3 * size], dtype=dtype
    )
    bias = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr), shape=[1, 3 * size], dtype=dtype,
        is_bias=True,
    )
    hidden = helper.create_tmp_variable(dtype, shape=(-1, size), lod_level=1)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru",
        inputs=inputs,
        outputs={"Hidden": [hidden]},
        attrs={
            "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "activation": candidate_activation,
        },
    )
    return hidden


def lstm_unit(
    x_t,
    hidden_t_prev,
    cell_t_prev,
    forget_bias=0.0,
    param_attr=None,
    bias_attr=None,
    **kwargs,
):
    """One dense LSTM step (reference nn.py lstm_unit:2194): fc over
    [x_t, h_prev] to 4H gates, then the cell update. Returns (h, c)."""
    helper = LayerHelper("lstm_unit", **kwargs)
    size = cell_t_prev.shape[-1]
    concat_out = tensor_layers.concat(input=[x_t, hidden_t_prev], axis=1)
    fc_out = fc(
        input=concat_out, size=4 * size, param_attr=param_attr,
        bias_attr=bias_attr,
    )
    dtype = x_t.dtype
    c = helper.create_tmp_variable(dtype, shape=(-1, size))
    h = helper.create_tmp_variable(dtype, shape=(-1, size))
    helper.append_op(
        type="lstm_unit",
        inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
        outputs={"C": [c], "H": [h]},
        attrs={"forget_bias": forget_bias},
    )
    return h, c


def gru_unit(
    input,
    hidden,
    size,
    param_attr=None,
    bias_attr=None,
    activation="tanh",
    gate_activation="sigmoid",
    **kwargs,
):
    """One dense GRU step (reference nn.py gru_unit). `size` is 3*hidden
    (paddle convention). Returns (hidden, reset_hidden_prev, gate)."""
    helper = LayerHelper("gru_unit", **kwargs)
    dtype = input.dtype
    H = size // 3
    weight = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=[H, 3 * H], dtype=dtype
    )
    bias = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr), shape=[1, 3 * H], dtype=dtype,
        is_bias=True,
    )
    gate = helper.create_tmp_variable(dtype, shape=(-1, 3 * H))
    reset_hidden_prev = helper.create_tmp_variable(dtype, shape=(-1, H))
    updated_hidden = helper.create_tmp_variable(dtype, shape=(-1, H))
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden], "Weight": [weight],
                "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden_prev],
                 "Hidden": [updated_hidden]},
        attrs={"activation": activation, "gate_activation": gate_activation},
    )
    return updated_hidden, reset_hidden_prev, gate


def sequence_conv(
    input, num_filters, filter_size=3, filter_stride=1, padding=None,
    bias_attr=None, param_attr=None, act=None, **kwargs
):
    """Context-window conv over a packed ragged batch (reference nn.py:1095,
    operators/sequence_conv_op): each token's window of `filter_size`
    neighbours is gathered (zero beyond sequence bounds) and hit with one
    GEMM."""
    helper = LayerHelper("sequence_conv", **kwargs)
    dtype = input.dtype
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(
        attr=ParamAttr.to_attr(param_attr), shape=filter_shape, dtype=dtype
    )
    pre_bias = helper.create_tmp_variable(dtype, shape=(-1, num_filters), lod_level=1)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [pre_bias]},
        attrs={
            "contextStride": filter_stride,
            "contextStart": -int(filter_size // 2),
            "contextLength": filter_size,
        },
    )
    helper.kwargs["bias_attr"] = bias_attr
    helper.kwargs["act"] = act
    pre_act = helper.append_bias_op(pre_bias)
    return helper.append_activation(pre_act)


def sequence_pool(input, pool_type, **kwargs):
    helper = LayerHelper("sequence_pool", input=input, **kwargs)
    dtype = helper.input_dtype()
    pool_out = helper.create_tmp_variable(dtype)
    max_index = helper.create_tmp_variable(dtype="int32", stop_gradient=True)
    helper.append_op(
        type="sequence_pool",
        inputs={"X": [input]},
        outputs={"Out": [pool_out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()},
    )
    return pool_out


def sequence_first_step(input, **kwargs):
    return sequence_pool(input, "first")


def sequence_last_step(input, **kwargs):
    return sequence_pool(input, "last")


def sequence_softmax(x, **kwargs):
    helper = LayerHelper("sequence_softmax", **kwargs)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="sequence_softmax", inputs={"X": [x]}, outputs={"Out": [out]}
    )
    return out


def sequence_reverse(x, name=None):
    """Reverse each sequence of a LoD tensor in time (kept LoD). Lowers
    reverse recurrent groups: reverse -> forward scan -> reverse."""
    helper = LayerHelper("sequence_reverse", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=1)
    helper.append_op(
        type="sequence_reverse", inputs={"X": [x]}, outputs={"Out": [out]}
    )
    return out


def sequence_expand(x, y, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype, lod_level=y.lod_level)
    helper.append_op(
        type="sequence_expand", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}
    )
    return out


def sequence_reshape(input, new_dim):
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype, lod_level=1)
    helper.append_op(
        type="sequence_reshape",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"new_dim": new_dim},
    )
    return out


def flash_attention(q, k, v, causal=False, scale=None, name=None):
    """Fused blockwise attention over [B, T, H, D] inputs: the port's
    flash kernels on the card (forward, dK/dV and dQ; csrc/
    flash_attention.cu), their plain versions on the CPU."""
    helper = LayerHelper("flash_attention", **locals())
    out = helper.create_tmp_variable(dtype=q.dtype, shape=tuple(q.shape))
    helper.append_op(
        type="flash_attention",
        inputs={"Q": [q], "K": [k], "V": [v]},
        outputs={"Out": [out]},
        attrs={"causal": bool(causal), "scale": scale},
    )
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", **locals())

    def _pair(v):
        return list(v) if isinstance(v, (list, tuple)) else [v, v]

    padding = padding if isinstance(padding, (list, tuple)) and len(padding) == 4 else _pair(padding) * 2
    out = helper.create_tmp_variable(dtype=input.dtype, lod_level=1)
    helper.append_op(
        type="im2sequence",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "kernels": _pair(filter_size),
            "strides": _pair(stride),
            "paddings": list(padding),
        },
    )
    return out


def row_conv(input, future_context_size, param_attr=None, act=None):
    helper = LayerHelper("row_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [future_context_size + 1, input.shape[-1]]
    filter_param = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype
    )
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="row_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [out]},
    )
    return helper.append_activation(out)


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", **locals())
    out = helper.create_tmp_variable(dtype=inputs[0].dtype)
    helper.append_op(
        type="multiplex",
        inputs={"X": inputs, "Ids": [index]},
        outputs={"Out": [out]},
    )
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="maxout",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"groups": groups},
    )
    return out


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="expand",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"expand_times": list(expand_times)},
    )
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="pad",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"paddings": list(paddings), "pad_value": float(pad_value)},
    )
    return out


def gather(input, index):
    helper = LayerHelper("gather", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="gather",
        inputs={"X": [input], "Index": [index]},
        outputs={"Out": [out]},
    )
    return out

def warpctc(input, label, blank=0, norm_by_times=False, **kwargs):
    """CTC loss over ragged logits/labels (reference layers/nn.py:2657 ->
    operators/warpctc_op; TPU-native log-space recursion in
    core/kernels_ctc.py instead of the dynloaded libwarpctc)."""
    helper = LayerHelper("warpctc", **kwargs)
    loss_out = helper.create_tmp_variable(dtype=input.dtype)
    grad_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="warpctc",
        inputs={"Logits": [input], "Label": [label]},
        outputs={"WarpCTCGrad": [grad_out], "Loss": [loss_out]},
        attrs={"blank": blank, "norm_by_times": norm_by_times},
    )
    return loss_out


def sequence_erase(input, tokens):
    """Remove the given token values from each sequence (reference
    operators/sequence_erase_op)."""
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="sequence_erase",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"tokens": list(tokens)},
    )
    return out


def edit_distance(input, label, normalized=False, ignored_tokens=None,
                  name=None):
    """Levenshtein distance between hypothesis and reference id sequences
    (reference layers/nn.py:2492 -> operators/edit_distance_op)."""
    helper = LayerHelper("edit_distance", **locals())
    if ignored_tokens is not None and len(ignored_tokens) > 0:
        input = sequence_erase(input, ignored_tokens)
        label = sequence_erase(label, ignored_tokens)
    out = helper.create_tmp_variable(dtype="float32")
    seq_num = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="edit_distance",
        inputs={"Hyps": [input], "Refs": [label]},
        outputs={"Out": [out], "SequenceNum": [seq_num]},
        attrs={"normalized": normalized},
    )
    return out, seq_num


def nce(input, label, num_total_classes, sample_weight=None, param_attr=None,
        bias_attr=None, num_neg_samples=None, neg_distribution=None):
    """Noise-contrastive estimation loss (reference layers/nn.py:2767 ->
    operators/nce_op)."""
    helper = LayerHelper("nce", **locals())
    dim = input.shape[1]
    num_true_class = label.shape[1] if label.shape and len(label.shape) > 1 else 1
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_total_classes, dim],
        is_bias=False, dtype=input.dtype,
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_total_classes, 1],
        is_bias=True, dtype=input.dtype,
    )
    cost = helper.create_tmp_variable(dtype=input.dtype)
    sample_logits = helper.create_tmp_variable(dtype=input.dtype)
    sample_labels = helper.create_tmp_variable(dtype=label.dtype)
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    inputs = {"Input": [input], "Label": [label], "Weight": [w], "Bias": [b]}
    if sample_weight is not None:
        inputs["SampleWeight"] = [sample_weight]
    helper.append_op(
        type="nce",
        inputs=inputs,
        outputs={
            "Cost": [cost],
            "SampleLogits": [sample_logits],
            "SampleLabels": [sample_labels],
        },
        attrs={
            "num_total_classes": int(num_total_classes),
            "num_neg_samples": num_neg_samples,
            "neg_distribution": (
                list(neg_distribution) if neg_distribution else None
            ),
        },
    )
    return cost


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None):
    """Hierarchical sigmoid loss over the complete binary class tree
    (reference operators/hierarchical_sigmoid_op, gserver
    HierarchicalSigmoidLayer)."""
    helper = LayerHelper("hsigmoid", **locals())
    dim = input.shape[1]
    w = helper.create_parameter(
        attr=helper.param_attr, shape=[num_classes - 1, dim],
        is_bias=False, dtype=input.dtype,
    )
    b = helper.create_parameter(
        attr=helper.bias_attr, shape=[num_classes - 1, 1],
        is_bias=True, dtype=input.dtype,
    )
    out = helper.create_tmp_variable(dtype=input.dtype)
    pre_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="hierarchical_sigmoid",
        inputs={"X": [input], "W": [w], "Label": [label], "Bias": [b]},
        outputs={"Out": [out], "PreOut": [pre_out]},
        attrs={"num_classes": int(num_classes)},
    )
    return out


def precision_recall(input, label, class_number, max_probs=None,
                     weights=None, states=None, **kwargs):
    """Multi-class precision/recall metrics (reference
    operators/precision_recall_op). `input` is the predicted class-index
    tensor (e.g. topk indices); returns (batch_metrics, accum_metrics,
    accum_states) where metrics = [macro-P, macro-R, macro-F1, micro-P,
    micro-R, micro-F1]."""
    helper = LayerHelper("precision_recall", **kwargs)
    batch_metrics = helper.create_tmp_variable(dtype="float32")
    accum_metrics = helper.create_tmp_variable(dtype="float32")
    accum_states = helper.create_tmp_variable(dtype="float32")
    inputs = {"Indices": [input], "Labels": [label]}
    if max_probs is not None:
        inputs["MaxProbs"] = [max_probs]
    if weights is not None:
        inputs["Weights"] = [weights]
    if states is not None:
        inputs["StatesInfo"] = [states]
    helper.append_op(
        type="precision_recall",
        inputs=inputs,
        outputs={
            "BatchMetrics": [batch_metrics],
            "AccumMetrics": [accum_metrics],
            "AccumStatesInfo": [accum_states],
        },
        attrs={"class_number": int(class_number)},
    )
    return batch_metrics, accum_metrics, accum_states


def sequence_context(input, context_length, context_start=None, name=None,
                     **kwargs):
    """Context-window concatenation without weights (reference
    ContextProjection; the gather half of sequence_conv). Output width is
    context_length * input_width."""
    helper = LayerHelper("sequence_context", name=name, **kwargs)
    width = None
    if input.shape and int(input.shape[-1]) > 0:
        width = int(input.shape[-1]) * int(context_length)
    out = helper.create_tmp_variable(
        dtype=input.dtype, shape=(-1, width) if width else None, lod_level=1
    )
    helper.append_op(
        type="sequence_context",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "context_length": int(context_length),
            "context_start": (
                -(int(context_length) // 2)
                if context_start is None else int(context_start)
            ),
        },
    )
    return out


def slice(input, axes, starts, ends, name=None):
    """Static slice (reference slice_op)."""
    helper = LayerHelper("slice", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="slice",
        inputs={"Input": [input]},
        outputs={"Out": [out]},
        attrs={"axes": list(axes), "starts": list(starts),
               "ends": list(ends)},
    )
    return out


def equal(x, y, name=None, **kwargs):
    """Elementwise x == y -> bool (reference equal op)."""
    helper = LayerHelper("equal", name=name)
    out = helper.create_tmp_variable(dtype="bool")
    out.stop_gradient = True
    helper.append_op(
        type="equal", inputs={"X": [x], "Y": [y]}, outputs={"Out": [out]}
    )
    return out


def sampling_id(x, name=None, **kwargs):
    """Sample a class id per row of a probability matrix (reference
    sampling_id_op)."""
    helper = LayerHelper("sampling_id", name=name)
    out = helper.create_tmp_variable(dtype="int32")
    out.stop_gradient = True
    helper.append_op(
        type="sampling_id", inputs={"X": [x]}, outputs={"Out": [out]}
    )
    return out


def bilinear_interp(input, out_h, out_w, name=None, **kwargs):
    """Bilinear resize on NCHW (reference bilinear_interp_op)."""
    helper = LayerHelper("bilinear_interp", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="bilinear_interp",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={"out_h": int(out_h), "out_w": int(out_w)},
    )
    return out


def conv_shift(x, y, name=None, **kwargs):
    """Circular convolution of each row of x by the (odd-width) kernel
    row of y (reference conv_shift_op)."""
    helper = LayerHelper("conv_shift", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="conv_shift", inputs={"X": [x], "Y": [y]},
        outputs={"Out": [out]},
    )
    return out


def sequence_slice(input, offset, length, name=None, **kwargs):
    """Per-sequence subranges (reference sequence_slice_op): row ranges
    [offset_i, offset_i+length_i) of each sequence, compacted."""
    helper = LayerHelper("sequence_slice", name=name)
    out = helper.create_tmp_variable(dtype=input.dtype, lod_level=1)
    helper.append_op(
        type="sequence_slice",
        inputs={"X": [input], "Offset": [offset], "Length": [length]},
        outputs={"Out": [out]},
    )
    return out


def reverse(x, axis, name=None, **kwargs):
    """Flip along axes (reference reverse_op)."""
    helper = LayerHelper("reverse", name=name)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="reverse", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": list(axis) if isinstance(axis, (list, tuple))
               else [axis]},
    )
    return out


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None, name=None,
           **kwargs):
    """3-D convolution, NCDHW (reference conv3d kernels under
    operators/conv_op.cc; legacy gserver Conv3DLayer.cpp)."""
    helper = LayerHelper("conv3d", **locals())
    dtype = helper.input_dtype()
    num_channels = input.shape[1]
    groups = groups or 1

    def _triple(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * 3

    filter_size = _triple(filter_size)
    stride = _triple(stride)
    padding = _triple(padding)
    dilation = _triple(dilation)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * int(np.prod(filter_size))
    w = helper.create_parameter(
        attr=helper.param_attr, shape=filter_shape, dtype=dtype,
        default_initializer=Normal(0.0, (2.0 / fan_in) ** 0.5, 0),
    )
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv3d",
        inputs={"Input": [input], "Filter": [w]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": stride, "paddings": padding,
               "dilations": dilation, "groups": groups},
    )
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool3d(input, pool_size, pool_type="max", pool_stride=1, pool_padding=0,
           global_pooling=False, ceil_mode=False, name=None, **kwargs):
    """3-D pooling, NCDHW (reference operators/pool_op.cc pool3d;
    legacy gserver Pool3DLayer.cpp)."""
    def _triple(v):
        return list(v) if isinstance(v, (list, tuple)) else [v] * 3

    helper = LayerHelper("pool3d", **locals())
    out = helper.create_tmp_variable(helper.input_dtype())
    helper.append_op(
        type="pool3d",
        inputs={"X": [input]},
        outputs={"Out": [out]},
        attrs={
            "pooling_type": pool_type,
            "ksize": _triple(pool_size),
            "strides": _triple(pool_stride),
            "paddings": _triple(pool_padding),
            "global_pooling": global_pooling,
            "ceil_mode": ceil_mode,
        },
    )
    return out


def prelu(x, mode="all", param_attr=None, name=None, **kwargs):
    """Parametric ReLU (reference prelu_op.cc; legacy PReluLayer).
    mode: 'all' one alpha, 'channel' per channel, 'element' per element."""
    helper = LayerHelper("prelu", **locals())
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [int(x.shape[1])]
    else:
        alpha_shape = [int(s) for s in x.shape[1:]]
    alpha = helper.create_parameter(
        attr=helper.param_attr, shape=alpha_shape, dtype=x.dtype,
        default_initializer=Constant(0.25),
    )
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="prelu", inputs={"X": [x], "Alpha": [alpha]},
        outputs={"Out": [out]}, attrs={"mode": mode},
    )
    return out


def crop(x, shape=None, offsets=None, name=None, **kwargs):
    """Crop a static window out of x (reference crop_op.cc; legacy
    CropLayer). shape/offsets are python lists over ALL axes."""
    helper = LayerHelper("crop", **locals())
    out = helper.create_tmp_variable(x.dtype)
    if offsets is None:
        offsets = [0] * len(shape)
    helper.append_op(
        type="crop", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"offsets": list(offsets), "shape": list(shape)},
    )
    return out


def roi_pool(input, rois, pooled_height, pooled_width, spatial_scale=1.0,
             name=None, **kwargs):
    """ROI max pooling (legacy gserver ROIPoolLayer.cpp). `rois` is an
    [R, 4] (x1,y1,x2,y2) tensor whose LoD maps ROIs to batch images."""
    helper = LayerHelper("roi_pool", **locals())
    out = helper.create_tmp_variable(input.dtype, lod_level=rois.lod_level)
    helper.append_op(
        type="roi_pool",
        inputs={"X": [input], "ROIs": [rois]},
        outputs={"Out": [out]},
        attrs={
            "pooled_height": pooled_height,
            "pooled_width": pooled_width,
            "spatial_scale": spatial_scale,
        },
    )
    return out


def scale_sub_region(x, indices, value, name=None, **kwargs):
    """Scale a per-sample (channel, height, width) box by `value`
    (legacy gserver ScaleSubRegionLayer.cpp; indices rows are 1-based
    inclusive [c0, c1, h0, h1, w0, w1])."""
    helper = LayerHelper("scale_sub_region", **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="scale_sub_region",
        inputs={"X": [x], "Indices": [indices]},
        outputs={"Out": [out]}, attrs={"value": value},
    )
    return out


def kmax_sequence_score(input, beam_size=1, name=None, **kwargs):
    """Within-sequence indices of each sequence's top-`beam_size` scores,
    -1 padded (legacy gserver KmaxSeqScoreLayer.cpp)."""
    helper = LayerHelper("kmax_seq_score", **locals())
    out = helper.create_tmp_variable("int32")
    helper.append_op(
        type="kmax_seq_score", inputs={"X": [input]},
        outputs={"Out": [out]}, attrs={"beam_size": beam_size},
    )
    return out


def sub_nested_seq(input, selected_indices, name=None, **kwargs):
    """Select sub-sequences of a nested (2-level LoD) sequence by index
    (legacy gserver SubNestedSequenceLayer.cpp). Output slot (i, j) is
    sub-sequence selected_indices[i, j] of sequence i (empty for -1)."""
    helper = LayerHelper("sub_nested_seq", **locals())
    out = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(
        type="sub_nested_seq",
        inputs={"X": [input], "S": [selected_indices]},
        outputs={"Out": [out]},
    )
    return out


def lambda_rank_cost(score, label, ndcg_num=5, name=None, **kwargs):
    """LambdaRank cost over score sequences (legacy gserver
    CostLayer.cpp LambdaCost): forward is per-sequence NDCG@ndcg_num
    broadcast over rows; backward is the lambda pairwise gradient."""
    helper = LayerHelper("lambda_rank", **locals())
    out = helper.create_tmp_variable(score.dtype, lod_level=1)
    helper.append_op(
        type="lambda_rank",
        inputs={"X": [score], "Score": [label]},
        outputs={"Out": [out]}, attrs={"NDCG_num": ndcg_num},
    )
    return out


__all__ += [
    "conv3d", "pool3d", "prelu", "crop", "roi_pool", "scale_sub_region",
    "kmax_sequence_score", "sub_nested_seq", "lambda_rank_cost",
    "sequence_reverse",
]


def lod_reset(x, y=None, target_lod=None, name=None, **kwargs):
    """Re-attach/replace a LoD on x (reference lod_reset_op.cc): from
    variable `y`'s LoD when given, else from the static `target_lod`."""
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(
        type="lod_reset", inputs=inputs, outputs={"Out": [out]},
        attrs={} if target_lod is None else {"target_lod": list(target_lod)},
    )
    return out


__all__.append("lod_reset")


def dynamic_lstmp(input, size, proj_size, param_attr=None, bias_attr=None,
                  use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None, **kwargs):
    """LSTM with recurrent projection over a ragged batch (reference
    nn.py:339 dynamic_lstmp, operators/lstmp_op). `size` is 4*hidden;
    `proj_size` is the projection width the recurrence runs on.
    Returns (projection, cell), LoD-shaped like the input."""
    helper = LayerHelper("dynamic_lstmp", name=name, **kwargs)
    hidden_size = size // 4
    attr = ParamAttr.to_attr(param_attr)
    weight = helper.create_parameter(
        attr=attr,
        shape=[proj_size, 4 * hidden_size], dtype=dtype,
    )
    # the projection weight needs its OWN attr object: create_parameter
    # fills in attr.name, so reusing the caller's would collide both
    # params on one (overwritten) variable. copy keeps every field
    # (regularizer, gradient_clip, ...) intact.
    import copy as _copy

    proj_attr = _copy.copy(attr)
    proj_attr.name = (attr.name + "_proj") if getattr(attr, "name", None) \
        else None
    proj_weight = helper.create_parameter(
        attr=proj_attr,
        shape=[hidden_size, proj_size], dtype=dtype,
    )
    bias_size = [1, 7 * hidden_size] if use_peepholes else [1, 4 * hidden_size]
    bias = helper.create_parameter(
        attr=ParamAttr.to_attr(bias_attr), shape=bias_size, dtype=dtype,
        is_bias=True,
    )
    projection = helper.create_tmp_variable(dtype, lod_level=1)
    cell = helper.create_tmp_variable(dtype, lod_level=1)
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [projection], "Cell": [cell]},
        attrs={
            "use_peepholes": use_peepholes, "is_reverse": is_reverse,
            "gate_activation": gate_activation,
            "cell_activation": cell_activation,
            "candidate_activation": candidate_activation,
            "proj_activation": proj_activation,
        },
    )
    return projection, cell


def ctc_greedy_decoder(input, blank, name=None, **kwargs):
    """CTC best-path decode: per-step argmax, collapse repeats, drop
    blanks (reference nn.py ctc_greedy_decoder, ctc_align_op)."""
    helper = LayerHelper("ctc_align", name=name, **kwargs)
    out = helper.create_tmp_variable("int32", lod_level=1)
    helper.append_op(
        type="ctc_align", inputs={"Input": [input]},
        outputs={"Output": [out]}, attrs={"blank": blank},
    )
    return out


def cumsum(x, axis=None, exclusive=False, reverse=False, name=None,
           **kwargs):
    """Cumulative sum (reference cum_op)."""
    helper = LayerHelper("cumsum", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="cumsum", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"axis": -1 if axis is None else axis,
               "exclusive": exclusive, "reverse": reverse},
    )
    return out


def _logical2(op_type):
    def layer(x, y, out=None, name=None, **kwargs):
        helper = LayerHelper(op_type, name=name, **kwargs)
        out_var = out or helper.create_tmp_variable("bool")
        helper.append_op(
            type=op_type, inputs={"X": [x], "Y": [y]},
            outputs={"Out": [out_var]},
        )
        return out_var

    layer.__name__ = op_type
    layer.__doc__ = "Elementwise %s (reference logical_op.cc)." % op_type
    return layer


logical_and = _logical2("logical_and")
logical_or = _logical2("logical_or")
logical_xor = _logical2("logical_xor")


def logical_not(x, out=None, name=None, **kwargs):
    """Elementwise NOT (reference logical_op.cc)."""
    helper = LayerHelper("logical_not", name=name, **kwargs)
    out_var = out or helper.create_tmp_variable("bool")
    helper.append_op(
        type="logical_not", inputs={"X": [x]}, outputs={"Out": [out_var]},
    )
    return out_var


def uniform_random(shape, dtype="float32", min=-1.0, max=1.0, seed=0,
                   name=None, **kwargs):
    """Uniform random tensor (reference uniform_random_op)."""
    helper = LayerHelper("uniform_random", name=name, **kwargs)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="uniform_random", inputs={}, outputs={"Out": [out]},
        attrs={"shape": list(shape), "min": min, "max": max, "seed": seed,
               "dtype": dtype},
    )
    return out


def lod_rank_table(x, level=0, name=None, **kwargs):
    """Rank table: sequences sorted by length descending, rows
    [original_index, length] (reference control_flow.py lod_rank_table)."""
    helper = LayerHelper("lod_rank_table", name=name, **kwargs)
    out = helper.create_tmp_variable("int32")
    helper.append_op(
        type="lod_rank_table", inputs={"X": [x]}, outputs={"Out": [out]},
        attrs={"level": level},
    )
    return out


def max_sequence_len(rank_table, name=None, **kwargs):
    """Longest sequence length from a rank table (reference
    max_sequence_len_op)."""
    helper = LayerHelper("max_sequence_len", name=name, **kwargs)
    out = helper.create_tmp_variable("int64")
    helper.append_op(
        type="max_sequence_len", inputs={"RankTable": [rank_table]},
        outputs={"Out": [out]},
    )
    return out


def reorder_lod_tensor_by_rank(x, rank_table, name=None, **kwargs):
    """Reorder sequences into rank-table order (reference
    reorder_lod_tensor_by_rank_op)."""
    helper = LayerHelper("reorder_lod_tensor_by_rank", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype, lod_level=1)
    helper.append_op(
        type="reorder_lod_tensor_by_rank",
        inputs={"X": [x], "RankTable": [rank_table]},
        outputs={"Out": [out]},
    )
    return out


def split_lod_tensor(input, mask, level=0, name=None, **kwargs):
    """Route rows into (true, false) branches by boolean mask (reference
    split_lod_tensor_op; the IfElse scatter half)."""
    helper = LayerHelper("split_lod_tensor", name=name, **kwargs)
    out_true = helper.create_tmp_variable(input.dtype, lod_level=1)
    out_false = helper.create_tmp_variable(input.dtype, lod_level=1)
    helper.append_op(
        type="split_lod_tensor",
        inputs={"X": [input], "Mask": [mask]},
        outputs={"OutTrue": [out_true], "OutFalse": [out_false]},
        attrs={"level": level},
    )
    return out_true, out_false


def merge_lod_tensor(in_true, in_false, x, mask, level=0, name=None,
                     **kwargs):
    """Inverse of split_lod_tensor (reference merge_lod_tensor_op)."""
    helper = LayerHelper("merge_lod_tensor", name=name, **kwargs)
    out = helper.create_tmp_variable(in_true.dtype)
    helper.append_op(
        type="merge_lod_tensor",
        inputs={"InTrue": [in_true], "InFalse": [in_false],
                "X": [x], "Mask": [mask]},
        outputs={"Out": [out]},
        attrs={"level": level},
    )
    return out


def lod_tensor_to_array(x, table, name=None, **kwargs):
    """Scatter a ragged batch into a time-step TensorArray in rank-table
    order (reference lod_tensor_to_array_op). Entries keep static [n, D]
    shapes with ended sequences masked to zero."""
    helper = LayerHelper("lod_tensor_to_array", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="lod_tensor_to_array",
        inputs={"X": [x], "RankTable": [table]},
        outputs={"Out": [out]},
    )
    return out


def array_to_lod_tensor(x, table, name=None, **kwargs):
    """Gather a time-step TensorArray back into packed ragged layout
    (reference array_to_lod_tensor_op)."""
    helper = LayerHelper("array_to_lod_tensor", name=name, **kwargs)
    out = helper.create_tmp_variable("float32", lod_level=1)
    helper.append_op(
        type="array_to_lod_tensor",
        inputs={"X": [x], "RankTable": [table]},
        outputs={"Out": [out]},
    )
    return out


def shrink_memory(x, i, table, name=None, **kwargs):
    """Mask RNN state rows of sequences finished before step i
    (reference shrink_rnn_memory_op; static-shape masked variant)."""
    helper = LayerHelper("shrink_rnn_memory", name=name, **kwargs)
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(
        type="shrink_rnn_memory",
        inputs={"X": [x], "I": [i], "RankTable": [table]},
        outputs={"Out": [out]},
    )
    return out


__all__ += [
    "dynamic_lstmp", "ctc_greedy_decoder", "cumsum", "logical_and",
    "logical_or", "logical_xor", "logical_not", "uniform_random",
    "lod_rank_table", "max_sequence_len", "reorder_lod_tensor_by_rank",
    "split_lod_tensor", "merge_lod_tensor", "lod_tensor_to_array",
    "array_to_lod_tensor", "shrink_memory",
]
