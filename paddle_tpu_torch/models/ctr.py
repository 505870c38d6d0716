"""CTR model family over the embedding path: Wide&Deep and DeepFM
(counterpart of paddle_tpu/models/ctr.py, built on the port's Fluid).

The reference serves this class of model through row-sharded sparse
pserver parameters (SparseRemoteParameterUpdater,
RemoteParameterUpdater.h:265 + SelectedRows). Here the graph is ordinary
fluid layers and the big per-field tables are plain `layers.embedding`
parameters, with the JAX builders' names and dense embeddings, so
weights carry across the two packages by name. Row-sharding the tables
over a mesh is not ported (the port has no mesh executor).

Both builders take integer feature-id inputs shaped [B, num_fields]
(one id per field, the classic Criteo-style layout) plus an optional
dense feature vector.
"""

from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["wide_deep", "deepfm"]


def _linear_term(ids, num_fields, vocab, table_name):
    """Per-id scalar weights summed over fields ([B, F] ids -> [B, 1]):
    the 'wide' linear model / FM first-order term — an embed_dim=1
    table."""
    w = fluid.layers.embedding(
        input=ids,
        size=[vocab, 1],
        param_attr=fluid.ParamAttr(name=table_name),
    )  # [B, F, 1]
    return fluid.layers.reduce_sum(
        fluid.layers.reshape(w, shape=[-1, num_fields]),
        dim=1, keep_dim=True,
    )


def _field_embeddings(ids, num_fields, vocab, dim, prefix):
    """Per-field embedding lookup: ids [B, F] int64 -> [B, F*dim] concat.
    One shared [vocab, dim] table per field group keeps the parameter
    count honest (fields index disjoint id ranges, as in Criteo
    preprocessing)."""
    emb = fluid.layers.embedding(
        input=ids,
        size=[vocab, dim],
        param_attr=fluid.ParamAttr(name="%s_table" % prefix),
    )
    # embedding of [B, F] ids -> [B, F, dim]; flatten the field axis
    return fluid.layers.reshape(emb, shape=[-1, num_fields * dim]), emb


def wide_deep(sparse_ids, label, num_fields, vocab, embed_dim=16,
              deep_dims=(128, 64), dense_input=None):
    """Wide&Deep (Cheng et al. 2016, the canonical pserver-era CTR
    model). Wide: a linear model over the raw ids (an embed_dim=1
    table = per-id weight). Deep: field embeddings -> MLP. Output:
    sigmoid(wide + deep); loss: mean logistic loss.

    Returns (loss, prob)."""
    # ---- wide: linear model over the raw ids
    wide = _linear_term(sparse_ids, num_fields, vocab, "wide_table")

    # ---- deep: embeddings -> MLP
    deep, _ = _field_embeddings(sparse_ids, num_fields, vocab, embed_dim,
                                "deep")
    if dense_input is not None:
        deep = fluid.layers.concat([deep, dense_input], axis=1)
    for i, width in enumerate(deep_dims):
        deep = fluid.layers.fc(input=deep, size=width, act="relu",
                               param_attr=fluid.ParamAttr(
                                   name="deep_fc%d_w" % i))
    deep_out = fluid.layers.fc(input=deep, size=1, act=None,
                               param_attr=fluid.ParamAttr(name="deep_out_w"))

    logit = fluid.layers.elementwise_add(x=wide, y=deep_out)
    loss = fluid.layers.mean(
        x=fluid.layers.sigmoid_cross_entropy_with_logits(
            x=logit, label=label))
    prob = fluid.layers.sigmoid(logit)
    return loss, prob


def deepfm(sparse_ids, label, num_fields, vocab, embed_dim=16,
           deep_dims=(128, 64), dense_input=None):
    """DeepFM (Guo et al. 2017): shared field embeddings feed BOTH the
    FM second-order interaction term and the deep MLP; plus a first-order
    per-id weight. FM pairwise sum uses the sum-square identity
    0.5 * sum_d[(Σ_f e_fd)² - Σ_f e_fd²]: a few elementwise ops instead
    of F² pairwise products.

    Returns (loss, prob)."""
    # first-order term
    first = _linear_term(sparse_ids, num_fields, vocab, "fm_w_table")

    flat, emb = _field_embeddings(sparse_ids, num_fields, vocab, embed_dim,
                                  "fm")
    # second-order: emb [B, F, D]
    sum_f = fluid.layers.reduce_sum(emb, dim=1)            # [B, D]
    sum_sq = fluid.layers.square(sum_f)                    # (Σe)²
    sq_sum = fluid.layers.reduce_sum(
        fluid.layers.square(emb), dim=1)                   # Σe²
    second = fluid.layers.scale(
        x=fluid.layers.reduce_sum(
            fluid.layers.elementwise_sub(x=sum_sq, y=sq_sum),
            dim=1, keep_dim=True),
        scale=0.5,
    )  # [B, 1]

    deep = flat
    if dense_input is not None:
        deep = fluid.layers.concat([deep, dense_input], axis=1)
    for i, width in enumerate(deep_dims):
        deep = fluid.layers.fc(input=deep, size=width, act="relu",
                               param_attr=fluid.ParamAttr(
                                   name="dfm_fc%d_w" % i))
    deep_out = fluid.layers.fc(input=deep, size=1, act=None,
                               param_attr=fluid.ParamAttr(name="dfm_out_w"))

    logit = fluid.layers.elementwise_add(
        x=fluid.layers.elementwise_add(x=first, y=second), y=deep_out)
    loss = fluid.layers.mean(
        x=fluid.layers.sigmoid_cross_entropy_with_logits(
            x=logit, label=label))
    prob = fluid.layers.sigmoid(logit)
    return loss, prob
