"""Composite network helpers (reference
python/paddle/trainer_config_helpers/networks.py): pure compositions
over the layer DSL — conv/pool blocks, separable conv, text conv, GRU /
LSTM units and groups, bidirectional RNNs, attention blocks, and the
VGG reference nets.

Every helper lowers onto existing DSL wrappers (one fluid Program, one
Executor run) — there is no new kernel surface here.

Attention note (documented divergence): simple_attention /
dot_product_attention / multi_head_attention compose at the SEQUENCE
level — the query ("decoder state") is a per-sequence vector expanded
over the attended sequence. The reference calls these inside a
recurrent_group step with the source as a StaticInput sequence; here
the equivalent in-step decoder path is the scan-lowered DynamicRNN
(tests/test_machine_translation.py).
"""

from __future__ import annotations

import paddle_tpu_torch.trainer_config_helpers as tch

__all__ = [
    "simple_img_conv_pool", "img_conv_bn_pool", "img_separable_conv",
    "sequence_conv_pool", "text_conv_pool",
    "simple_gru", "simple_gru2", "gru_unit", "gru_group",
    "lstmemory_unit", "lstmemory_group",
    "bidirectional_gru", "bidirectional_lstm",
    "simple_attention", "dot_product_attention", "multi_head_attention",
    "small_vgg", "vgg_16_network", "inputs", "outputs",
]

outputs = tch.outputs


def inputs(layers, *args):
    """Declare feed order from layer nodes (reference networks.py
    inputs())."""
    nodes = tch._as_list(layers) + list(args)
    tch.Inputs(*[n.name for n in nodes])


# ---------------------------------------------------------------------
# image blocks
# ---------------------------------------------------------------------


def simple_img_conv_pool(input, filter_size, num_filters, pool_size,
                         name=None, pool_type=None, act=None, groups=1,
                         conv_stride=1, conv_padding=0, bias_attr=None,
                         num_channel=None, param_attr=None,
                         pool_stride=1, pool_padding=0, **kwargs):
    """conv -> pool (reference networks.py simple_img_conv_pool)."""
    conv = tch.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, stride=conv_stride,
        padding=conv_padding, groups=groups, act=act,
        bias_attr=bias_attr, param_attr=param_attr,
        name=None if name is None else name + "_conv",
    )
    return tch.img_pool_layer(
        input=conv, pool_size=pool_size, stride=pool_stride,
        padding=pool_padding, pool_type=pool_type, name=name,
    )


def img_conv_bn_pool(input, filter_size, num_filters, pool_size,
                     name=None, pool_type=None, act=None, groups=1,
                     conv_stride=1, conv_padding=0, conv_bias_attr=None,
                     num_channel=None, conv_param_attr=None,
                     pool_stride=1, pool_padding=0, **kwargs):
    """conv -> batch_norm(act) -> pool (reference img_conv_bn_pool)."""
    conv = tch.img_conv_layer(
        input=input, filter_size=filter_size, num_filters=num_filters,
        num_channels=num_channel, stride=conv_stride,
        padding=conv_padding, groups=groups, act=None,
        bias_attr=conv_bias_attr, param_attr=conv_param_attr,
        name=None if name is None else name + "_conv",
    )
    bn = tch.batch_norm_layer(input=conv, act=act)
    return tch.img_pool_layer(
        input=bn, pool_size=pool_size, stride=pool_stride,
        padding=pool_padding, pool_type=pool_type, name=name,
    )


def img_separable_conv(input, num_channels, num_out_channels, filter_size,
                       stride=1, padding=0, depth_multiplier=1, act=None,
                       bias_attr=None, param_attr=None, name=None,
                       **kwargs):
    """Depthwise conv (groups = channels) then 1x1 pointwise conv
    (reference img_separable_conv)."""
    depthwise = tch.img_conv_layer(
        input=input, filter_size=filter_size,
        num_filters=num_channels * depth_multiplier,
        num_channels=num_channels, stride=stride, padding=padding,
        groups=num_channels, act=None, bias_attr=bias_attr,
        param_attr=param_attr,
        name=None if name is None else name + "_dw",
    )
    return tch.img_conv_layer(
        input=depthwise, filter_size=1, num_filters=num_out_channels,
        stride=1, padding=0, act=act, bias_attr=bias_attr,
        param_attr=param_attr, name=name,
    )


def sequence_conv_pool(input, context_len, hidden_size, name=None,
                       context_start=None, pool_type=None,
                       fc_param_attr=None, fc_bias_attr=None,
                       fc_act=None, **kwargs):
    """Context window -> fc -> sequence pool (reference
    sequence_conv_pool): the text-convolution block of the sentiment /
    text-classification configs."""
    with tch.mixed_layer(
        size=hidden_size,
        name=None if name is None else name + "_conv",
    ) as m:
        m += tch.context_projection(
            input=input, context_len=context_len,
            context_start=context_start,
        )
    fc = tch.fc_layer(
        input=m, size=hidden_size,
        act=fc_act or tch.TanhActivation(),
        param_attr=fc_param_attr, bias_attr=fc_bias_attr,
    )
    return tch.pooling_layer(
        input=fc, pooling_type=pool_type or tch.MaxPooling(), name=name,
    )


text_conv_pool = sequence_conv_pool


# ---------------------------------------------------------------------
# recurrent units / groups
# ---------------------------------------------------------------------


def simple_gru(input, size, name=None, reverse=False,
               mixed_param_attr=None, mixed_bias_param_attr=None,
               gru_bias_attr=None, gru_param_attr=None, act=None,
               gate_act=None, **kwargs):
    """3H input projection + fused GRU recurrence (reference
    simple_gru = mixed_layer + grumemory)."""
    with tch.mixed_layer(
        size=size * 3, bias_attr=mixed_bias_param_attr,
        name=None if name is None else name + "_transform",
    ) as m:
        m += tch.full_matrix_projection(
            input=input, param_attr=mixed_param_attr,
        )
    return tch.grumemory(input=m, size=size, reverse=reverse, name=name)


def simple_gru2(input, size, name=None, reverse=False,
                mixed_param_attr=None, mixed_bias_attr=None,
                gru_param_attr=None, gru_bias_attr=None, act=None,
                gate_act=None, **kwargs):
    """Identical math to simple_gru (the reference variant differs only
    in parameter layout for speed, networks.py simple_gru2)."""
    return simple_gru(
        input=input, size=size, name=name, reverse=reverse,
        mixed_param_attr=mixed_param_attr,
        mixed_bias_param_attr=mixed_bias_attr,
        gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
        act=act, gate_act=gate_act,
    )


def gru_unit(input, memory_boot=None, size=None, name=None,
             gru_bias_attr=None, gru_param_attr=None, act=None,
             gate_act=None, naive=False, **kwargs):
    """One GRU step with its own output memory — use inside a
    recurrent_group step function (reference gru_unit)."""
    out_name = name or tch.Layer("gru_unit_anchor", None, [], {}).name
    mem = tch.memory(name=out_name, size=size, boot_layer=memory_boot)
    return tch.gru_step_layer(
        input=input, output_mem=mem, size=size, name=out_name,
        act=act, gate_act=gate_act, param_attr=gru_param_attr,
        bias_attr=gru_bias_attr,
    )


def gru_group(input, memory_boot=None, size=None, name=None,
              reverse=False, gru_bias_attr=None, gru_param_attr=None,
              act=None, gate_act=None, naive=False, **kwargs):
    """recurrent_group wrapping gru_unit (reference gru_group): the
    step-level form of a GRU over a sequence (already 3H-projected)."""

    def step(x):
        return gru_unit(
            input=x, memory_boot=memory_boot, size=size,
            name=None if name is None else name + "_unit",
            gru_bias_attr=gru_bias_attr, gru_param_attr=gru_param_attr,
            act=act, gate_act=gate_act,
        )

    return recurrent_group_alias(step, input, reverse=reverse, name=name)


# recurrent_group is imported lazily so the module can be star-imported
# into configs without shadowing
def recurrent_group_alias(step, input, reverse=False, name=None):
    return tch.recurrent_group(step, input, reverse=reverse, name=name)


def lstmemory_unit(input, out_memory=None, name=None, size=None,
                   param_attr=None, act=None, gate_act=None,
                   state_act=None, input_proj_bias_attr=None,
                   lstm_bias_attr=None, **kwargs):
    """One LSTM step with hidden+cell memories — use inside a
    recurrent_group step (reference lstmemory_unit): the input and the
    previous hidden are projected to 4H, the cell rides a second memory
    closed by get_output_layer(..., 'state')."""
    if size is None:
        raise ValueError("lstmemory_unit needs an explicit size")
    out_name = name or tch.Layer("lstm_unit_anchor", None, [], {}).name
    if out_memory is None:
        out_mem = tch.memory(name=out_name, size=size)
    else:
        out_mem = out_memory
    state_mem = tch.memory(name=out_name + "_state", size=size)
    # two projections of DIFFERENT input widths: a shared ParamAttr
    # name would alias one weight for both — derive distinct names
    pa_in = pa_rec = None
    if param_attr is not None:
        base = getattr(param_attr, "name", None)
        pa_in = tch.ParamAttr(name=(base + "_in") if base else None)
        pa_rec = tch.ParamAttr(name=(base + "_rec") if base else None)
    with tch.mixed_layer(
        size=size * 4, bias_attr=input_proj_bias_attr,
        name=out_name + "_input_proj",
    ) as m:
        m += tch.full_matrix_projection(input=input, param_attr=pa_in)
        m += tch.full_matrix_projection(input=out_mem, param_attr=pa_rec)
    step_l = tch.lstm_step_layer(
        input=m, state=state_mem, size=size, name=out_name,
        act=act, gate_act=gate_act, state_act=state_act,
    )
    tch.get_output_layer(input=step_l, arg_name="state",
                         name=out_name + "_state")
    return step_l


def lstmemory_group(input, size=None, name=None, out_memory=None,
                    reverse=False, param_attr=None, act=None,
                    gate_act=None, state_act=None,
                    input_proj_bias_attr=None, lstm_bias_attr=None,
                    **kwargs):
    """recurrent_group wrapping lstmemory_unit (reference
    lstmemory_group)."""

    def step(x):
        return lstmemory_unit(
            input=x, out_memory=out_memory, size=size,
            name=None if name is None else name + "_unit",
            param_attr=param_attr, act=act, gate_act=gate_act,
            state_act=state_act,
            input_proj_bias_attr=input_proj_bias_attr,
            lstm_bias_attr=lstm_bias_attr,
        )

    return recurrent_group_alias(step, input, reverse=reverse, name=name)


def bidirectional_gru(input, size, name=None, return_seq=False, **kwargs):
    """Forward + backward simple_gru, concatenated (reference
    bidirectional_gru): last fwd step + first bwd step when
    return_seq=False, full sequences otherwise."""
    fwd = simple_gru(input=input, size=size, reverse=False,
                     name=None if name is None else name + "_fwd")
    bwd = simple_gru(input=input, size=size, reverse=True,
                     name=None if name is None else name + "_bwd")
    if return_seq:
        return tch.concat_layer(input=[fwd, bwd], name=name)
    return tch.concat_layer(
        input=[tch.last_seq(input=fwd), tch.first_seq(input=bwd)],
        name=name,
    )


def bidirectional_lstm(input, size, name=None, return_seq=False,
                       **kwargs):
    """Forward + backward simple_lstm, concatenated (reference
    bidirectional_lstm)."""
    fwd = tch.simple_lstm(input=input, size=size,
                          name=None if name is None else name + "_fwd")
    bwd = tch.simple_lstm(input=input, size=size, reverse=True,
                          name=None if name is None else name + "_bwd")
    if return_seq:
        return tch.concat_layer(input=[fwd, bwd], name=name)
    return tch.concat_layer(
        input=[tch.last_seq(input=fwd), tch.first_seq(input=bwd)],
        name=name,
    )


# ---------------------------------------------------------------------
# attention blocks (sequence-level — see module docstring)
# ---------------------------------------------------------------------


def _node_width(node):
    """Feature width of a DSL node (size attr, or a data layer's dim)."""
    a = getattr(node, "attrs", {})
    if a.get("size"):
        return int(a["size"])
    t = a.get("type")
    if t is not None:
        return int(t.dim)
    if getattr(node, "parents", None):
        return _node_width(node.parents[0])
    raise ValueError("cannot infer width of %r" % node)


def simple_attention(encoded_sequence, encoded_proj, decoder_state,
                     transform_param_attr=None, softmax_param_attr=None,
                     weight_act=None, name=None, **kwargs):
    """Bahdanau additive attention (reference simple_attention):
    tanh(W s + encoded_proj) -> per-step scalar -> sequence softmax ->
    weighted sum of encoded_sequence."""
    proj_size = _node_width(encoded_proj)
    with tch.mixed_layer(
        size=proj_size,
        name=None if name is None else name + "_transform",
    ) as state_proj:
        state_proj += tch.full_matrix_projection(
            input=decoder_state, param_attr=transform_param_attr,
        )
    expanded = tch.expand_layer(input=state_proj,
                                expand_as=encoded_proj)
    combined = tch.addto_layer(input=[expanded, encoded_proj],
                               act=tch.TanhActivation())
    weight = tch.fc_layer(
        input=combined, size=1,
        act=weight_act or tch.SequenceSoftmaxActivation(),
        param_attr=softmax_param_attr, bias_attr=False,
        name=None if name is None else name + "_weight",
    )
    scaled = tch.scaling_layer(input=encoded_sequence, weight=weight)
    return tch.pooling_layer(input=scaled,
                             pooling_type=tch.SumPooling(), name=name)


def dot_product_attention(encoded_sequence, attended_sequence,
                          transformed_state, softmax_param_attr=None,
                          name=None, **kwargs):
    """Dot-product attention (reference dot_product_attention): scores
    are <state, encoded_t>, softmaxed over the sequence, applied to
    attended_sequence."""
    expanded = tch.expand_layer(input=transformed_state,
                                expand_as=encoded_sequence)
    scores = tch.dot_prod_layer(a=expanded, b=encoded_sequence)
    with tch.mixed_layer(
        size=1, act=tch.SequenceSoftmaxActivation(),
        name=None if name is None else name + "_weight",
    ) as weight:
        weight += tch.identity_projection(input=scores)
    scaled = tch.scaling_layer(input=attended_sequence, weight=weight)
    return tch.pooling_layer(input=scaled,
                             pooling_type=tch.SumPooling(), name=name)


def multi_head_attention(query, key, value, key_proj_size,
                         value_proj_size, head_num,
                         attention_type="dot-product attention",
                         softmax_param_attr=None, name=None, **kwargs):
    """Multi-head attention (reference multi_head_attention): per head,
    project query/key/value, score (dot-product or additive), sequence
    softmax, weighted value sum; heads concatenate."""
    heads = []
    for h in range(head_num):
        hname = "%s_h%d" % (name or "mha", h)
        q_h = tch.fc_layer(input=query, size=key_proj_size,
                           bias_attr=False, name=hname + "_q")
        k_h = tch.fc_layer(input=key, size=key_proj_size,
                           bias_attr=False, name=hname + "_k")
        v_h = tch.fc_layer(input=value, size=value_proj_size,
                           bias_attr=False, name=hname + "_v")
        if "dot" in attention_type:
            heads.append(dot_product_attention(
                encoded_sequence=k_h, attended_sequence=v_h,
                transformed_state=q_h, name=hname))
        else:
            heads.append(simple_attention(
                encoded_sequence=v_h, encoded_proj=k_h,
                decoder_state=query, name=hname))
    return tch.concat_layer(input=heads, name=name)


# ---------------------------------------------------------------------
# VGG reference nets
# ---------------------------------------------------------------------


def _vgg(input_image, num_channels, num_classes, groups, fc_dim=4096,
         drop_rate=0.5):
    tmp = input_image
    filters = [64, 128, 256, 512, 512]
    for i, g in enumerate(groups):
        tmp = tch.img_conv_group(
            input=tmp, conv_num_filter=[filters[min(i, 4)]] * g,
            conv_filter_size=3, conv_padding=1,
            conv_act=tch.ReluActivation(),
            num_channels=num_channels if i == 0 else None,
            pool_size=2, pool_stride=2, pool_type=tch.MaxPooling(),
        )
    tmp = tch.fc_layer(input=tmp, size=fc_dim,
                       act=tch.ReluActivation())
    tmp = tch.dropout_layer(input=tmp, dropout_rate=drop_rate)
    tmp = tch.fc_layer(input=tmp, size=fc_dim,
                       act=tch.ReluActivation())
    tmp = tch.dropout_layer(input=tmp, dropout_rate=drop_rate)
    return tch.fc_layer(input=tmp, size=num_classes,
                        act=tch.SoftmaxActivation())


def small_vgg(input_image, num_channels, num_classes, **kwargs):
    """The CIFAR-scale VGG (reference small_vgg: 4 conv groups of
    [2, 2, 3, 3], fc 512)."""
    return _vgg(input_image, num_channels, num_classes,
                groups=[2, 2, 3, 3], fc_dim=512)


def vgg_16_network(input_image, num_channels, num_classes=1000,
                   **kwargs):
    """VGG-16 (reference vgg_16_network: conv groups [2, 2, 3, 3, 3],
    fc 4096)."""
    return _vgg(input_image, num_channels, num_classes,
                groups=[2, 2, 3, 3, 3], fc_dim=4096)
