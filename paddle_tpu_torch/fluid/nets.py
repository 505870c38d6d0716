"""Composite network helpers (counterpart of paddle_tpu/fluid/nets.py;
reference python/paddle/v2/fluid/nets.py: simple_img_conv_pool,
img_conv_group, sequence_conv_pool, glu, scaled_dot_product_attention),
built on the port's layers."""

from __future__ import annotations

from . import layers

__all__ = [
    "simple_img_conv_pool",
    "sequence_conv_pool",
    "glu",
    "img_conv_group",
    "scaled_dot_product_attention",
]


def simple_img_conv_pool(
    input,
    num_filters,
    filter_size,
    pool_size,
    pool_stride,
    act,
    param_attr=None,
    pool_type="max",
    use_cudnn=True,
    use_mkldnn=False,
):
    conv_out = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act,
    )
    return layers.pool2d(
        input=conv_out,
        pool_size=pool_size,
        pool_type=pool_type,
        pool_stride=pool_stride,
    )


def img_conv_group(
    input,
    conv_num_filter,
    pool_size,
    conv_padding=1,
    conv_filter_size=3,
    conv_act=None,
    param_attr=None,
    conv_with_batchnorm=False,
    conv_batchnorm_drop_rate=0.0,
    pool_stride=1,
    pool_type=None,
    use_cudnn=True,
    use_mkldnn=False,
):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def __extend_list__(obj):
        if not hasattr(obj, "__len__"):
            return [obj] * len(conv_num_filter)
        return list(obj)

    conv_padding = __extend_list__(conv_padding)
    conv_filter_size = __extend_list__(conv_filter_size)
    param_attr = __extend_list__(param_attr)
    conv_with_batchnorm = __extend_list__(conv_with_batchnorm)
    conv_batchnorm_drop_rate = __extend_list__(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(
            input=tmp,
            num_filters=conv_num_filter[i],
            filter_size=conv_filter_size[i],
            padding=conv_padding[i],
            param_attr=param_attr[i],
            act=local_conv_act,
        )
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)

    return layers.pool2d(
        input=tmp, pool_size=pool_size, pool_type=pool_type, pool_stride=pool_stride
    )


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None, act="sigmoid", pool_type="max"):
    conv_out = layers.sequence_conv(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        param_attr=param_attr,
        act=act,
    )
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)


def glu(input, dim=-1):
    a, b = layers.split(input, num_or_sections=2, dim=dim)
    act_b = layers.sigmoid(x=b)
    return layers.elementwise_mul(x=a, y=act_b)


def scaled_dot_product_attention(queries, keys, values, num_heads=1, dropout_rate=0.0):
    """Multi-head scaled dot-product attention (reference nets.py). Inputs
    [batch, len, dim]; heads split/recombined around one batched matmul."""
    if queries.shape[-1] != keys.shape[-1]:
        raise ValueError("queries and keys must have the same hidden width")
    if keys.shape[-2] != values.shape[-2] if len(values.shape) > 2 else False:
        raise ValueError("keys and values must agree on sequence length")

    def __split_heads(x, num_heads):
        if num_heads == 1:
            return x
        hidden_size = x.shape[-1]
        reshaped = layers.reshape(
            x=x, shape=list(x.shape[:-1]) + [num_heads, hidden_size // num_heads]
        )
        return layers.transpose(x=reshaped, perm=[0, 2, 1, 3])

    def __combine_heads(x):
        if len(x.shape) == 3:
            return x
        trans = layers.transpose(x, perm=[0, 2, 1, 3])
        return layers.reshape(
            x=trans, shape=[trans.shape[0], trans.shape[1], trans.shape[2] * trans.shape[3]]
        )

    q = __split_heads(queries, num_heads)
    k = __split_heads(keys, num_heads)
    v = __split_heads(values, num_heads)

    key_dim_per_head = keys.shape[-1] // num_heads
    scaled_q = layers.scale(x=q, scale=key_dim_per_head ** -0.5)
    product = layers.matmul(x=scaled_q, y=k, transpose_y=True)
    weights = layers.reshape(
        x=product,
        shape=[-1, product.shape[-1]],
    )
    weights = layers.softmax(x=weights)
    weights = layers.reshape(x=weights, shape=list(product.shape))
    if dropout_rate:
        weights = layers.dropout(x=weights, dropout_prob=dropout_rate, is_test=False)
    ctx_multiheads = layers.matmul(weights, v)
    return __combine_heads(ctx_multiheads)
