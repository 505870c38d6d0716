"""The legacy config DSL (trainer_config_helpers) and the v2 Topology of
the port against the JAX package's: the cases of tests/test_legacy_dsl.py
and tests/test_networks_helpers.py that need no reference tree, each
built through both DSLs (the two programs must be the same, op for op,
with the same attrs and variable shapes) and run through both executors
from the same weights on the same feeds.

Tolerances: forward values rtol 1e-5, atol 1e-6 (f32; integer outputs
exactly); the cases that train take SGD steps (not the JAX tests' Adam,
which steps noise-level gradients by ~lr in either package) and hold
losses and every persistable at the same rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest

from torch_legacy import build_both, run_both, sub, assert_same_program


def _lod(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


# --- mixed layer, projections, recurrent groups, generation -------------

def mixed_full_trans(tch):
    data = tch.data_layer(name="mx_in", size=4)
    fc4 = tch.fc_layer(input=data, size=5, bias_attr=False,
                       act=tch.LinearActivation(),
                       param_attr=tch.ParamAttr(name="mx_share"))
    with tch.mixed_layer(size=4, act=tch.LinearActivation()) as m:
        m += tch.full_matrix_projection(input=data)
        m += tch.trans_full_matrix_projection(
            input=fc4, param_attr=tch.ParamAttr(name="mx_share"))
    cost = tch.sum_cost(m)
    return {"m": m, "cost": cost}


def identity_context(tch):
    data = tch.data_layer(name="cx_in", size=3)
    with tch.mixed_layer(size=3) as m:
        m += tch.identity_projection(input=data)
    with tch.mixed_layer(size=6) as c:
        c += tch.context_projection(input=data, context_len=2,
                                    context_start=0)
    return {"m": m, "c": c}


def recurrent_group(tch):
    dict_dim, word_dim, hidden, label_dim = 10, 8, 8, 3
    data = tch.data_layer(name="rg_word", size=dict_dim)
    emb = tch.embedding_layer(input=data, size=word_dim)

    def step(y):
        mem = tch.memory(name="rg_state", size=hidden)
        return tch.fc_layer(input=[y, mem], size=hidden,
                            act=tch.TanhActivation(), bias_attr=True,
                            name="rg_state")

    out = tch.recurrent_group(name="rg_rnn", step=step, input=emb)
    prob = tch.fc_layer(input=tch.last_seq(input=out), size=label_dim,
                        act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="rg_label", size=label_dim)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def recurrent_reverse(tch):
    data = tch.data_layer(name="rev_x", size=4)
    rec = tch.recurrent_layer(input=data, reverse=True,
                              act=tch.TanhActivation(),
                              param_attr=tch.ParamAttr(name="rev_w"),
                              name="revrec")
    return {"rec": rec, "cost": tch.sum_cost(tch.last_seq(input=rec))}


def lstm_step_group(tch):
    dict_dim, word_dim, H = 8, 6, 5
    words = tch.data_layer(name="r3_w", size=dict_dim)
    emb = tch.embedding_layer(input=words, size=word_dim)

    def step(y):
        c_mem = tch.memory(name="r3_c", size=H)
        x4h = tch.fc_layer(input=[y], size=H * 4, bias_attr=True)
        h = tch.lstm_step_layer(input=x4h, state=c_mem, size=H,
                                name="r3_h")
        tch.get_output_layer(input=h, arg_name="state", name="r3_c")
        return h

    out = tch.recurrent_group(name="r3_rnn", step=step, input=emb)
    prob = tch.fc_layer(input=tch.last_seq(input=out), size=3,
                        act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="r3_y", size=3)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def gru_step_group(tch):
    dict_dim, word_dim, H = 8, 6, 5
    words = tch.data_layer(name="g_w", size=dict_dim)
    emb = tch.embedding_layer(input=words, size=word_dim)

    def step(y):
        mem = tch.memory(name="g_h", size=H)
        x3h = tch.fc_layer(input=[y], size=H * 3, bias_attr=False)
        return tch.gru_step_layer(input=x3h, output_mem=mem, size=H,
                                  name="g_h")

    out = tch.recurrent_group(name="g_rnn", step=step, input=emb)
    prob = tch.fc_layer(input=tch.last_seq(input=out), size=3,
                        act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="g_y", size=3)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def beam_gen(tch):
    num_words = 5
    dummy = tch.data_layer(name="bs_dummy", size=2)

    def step(dummy_memory, predict_word):
        with tch.mixed_layer(size=num_words) as layer:
            layer += tch.full_matrix_projection(
                input=predict_word,
                param_attr=tch.ParamAttr(name="bs_transtable"))
        with tch.mixed_layer(size=num_words,
                             act=tch.ExpActivation()) as out:
            out += tch.trans_full_matrix_projection(
                input=layer, param_attr=tch.ParamAttr(name="bs_wordvec"))
        return out

    gen = tch.beam_search(
        name="bs_gen", step=step, bos_id=0, eos_id=num_words - 1,
        beam_size=1, max_length=6,
        input=[tch.StaticInput(input=dummy, size=2),
               tch.GeneratedInput(size=num_words,
                                  embedding_name="bs_wordvec",
                                  embedding_size=num_words)])
    return {"gen": gen}


# --- breadth wrappers ---------------------------------------------------

def breadth_forward(tch):
    a = tch.data_layer(name="bw_a", size=4)
    b = tch.data_layer(name="bw_b", size=4)
    w = tch.data_layer(name="bw_w", size=1)
    return {
        "cos": tch.cos_sim(a, b, scale=2.0),
        "trans": tch.trans_layer(a),
        "power": tch.power_layer(a, w),
        "scaling": tch.scaling_layer(a, w),
        "interp": tch.interpolation_layer([a, b], w),
        "slope": tch.slope_intercept_layer(a, slope=2.0, intercept=1.0),
        "s1norm": tch.sum_to_one_norm_layer(a),
        "l2row": tch.row_l2_norm_layer(a),
        "dot": tch.dot_prod_layer(a, b),
        "outer": tch.out_prod_layer(a, b),
        "l2d": tch.l2_distance_layer(a, b),
        "clip": tch.clip_layer(a, min=0.6, max=1.2),
        "scale_shift": tch.scale_shift_layer(a),
        "gated": tch.gated_unit_layer(a, size=5, act=tch.TanhActivation()),
        "sumc": tch.sum_cost(a),
        "huber": tch.huber_regression_cost(tch.dot_prod_layer(a, b), w),
        "smooth": tch.smooth_l1_cost(a, b),
        "mbce": tch.multi_binary_label_cross_entropy(
            tch.fc_layer(input=a, size=4, act=tch.SigmoidActivation()), b),
    }


def sequence_wrappers(tch):
    seq = tch.data_layer(name="bs_seq", size=4)
    e2 = tch.embedding_layer(input=seq, size=6)
    left = tch.data_layer(name="bs_left", size=1)
    right = tch.data_layer(name="bs_right", size=1)
    rl = tch.data_layer(name="bs_rl", size=1)
    return {"rc": tch.row_conv_layer(input=e2, context_len=2),
            "rs": tch.seq_reshape_layer(input=e2, reshape_size=3),
            "rank": tch.rank_cost(left, right, rl)}


def recurrent_layer_train(tch):
    words = tch.data_layer(name="br_w", size=8)
    emb = tch.embedding_layer(input=words, size=6)
    rec = tch.recurrent_layer(input=emb, act=tch.TanhActivation(),
                              name="br_rec")
    prob = tch.fc_layer(input=tch.last_seq(input=rec), size=3,
                        act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="br_y", size=3)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def image_structured(tch):
    img = tch.data_layer(name="bi_img", size=4 * 6 * 6, height=6, width=6)
    sel = tch.data_layer(name="bi_sel", size=1)
    x1 = tch.data_layer(name="bi_x1", size=3)
    x2 = tch.data_layer(name="bi_x2", size=3)
    return {"mo": tch.maxout_layer(input=img, groups=2),
            "pad": tch.pad_layer(input=img, pad_c=[0, 0], pad_h=[1, 1],
                                 pad_w=[1, 1]),
            "blocks": tch.block_expand_layer(input=img, block_x=3,
                                             block_y=3, stride_x=3,
                                             stride_y=3),
            "mux": tch.multiplex_layer([sel, x1, x2]),
            "rep": tch.repeat_layer(input=x1, num_repeats=2)}


def crf_ctc(tch):
    emission = tch.data_layer(name="bc_em", size=4)
    tags = tch.data_layer(name="bc_tag", size=4)
    frames = tch.data_layer(name="bc_fr", size=6)
    labels = tch.data_layer(name="bc_lb", size=5)
    return {"crf": tch.crf_layer(input=emission, label=tags,
                                 param_attr=tch.ParamAttr(name="bc_trans")),
            "decode": tch.crf_decoding_layer(input=emission, size=4),
            "ctc": tch.warp_ctc_layer(input=frames, label=labels, size=6)}


def round2(tch):
    img = tch.data_layer(name="r2_img", size=3 * 4 * 4, height=4, width=4)
    a = tch.data_layer(name="r2_a", size=5)
    b = tch.data_layer(name="r2_b", size=5)
    k = tch.data_layer(name="r2_k", size=3)
    with tch.mixed_layer(size=5) as dm:
        dm += tch.dotmul_operator(a=a, b=b, scale=2.0)
    lab = tch.data_layer(name="r2_y", size=1)
    return {"bi": tch.bilinear_interp_layer(input=img, out_size_x=8,
                                            out_size_y=8),
            "sw": tch.switch_order_layer(input=img),
            "sp": tch.spp_layer(input=img, pyramid_height=2),
            "cs": tch.conv_shift_layer(a, k),
            "dm": dm,
            "fm": tch.factorization_machine(input=a, factor_size=4),
            "hub": tch.huber_classification_cost(
                input=tch.dot_prod_layer(a, b), label=lab)}


def tensor_subseq(tch):
    a = tch.data_layer(name="r3_a", size=3)
    b = tch.data_layer(name="r3_b", size=4)
    seq = tch.data_layer(name="r3_seq", size=2)
    emb2 = tch.embedding_layer(input=seq, size=4)
    offs = tch.data_layer(name="r3_off", size=1)
    sizes = tch.data_layer(name="r3_sz", size=1)
    return {"tl": tch.tensor_layer(a=a, b=b, size=2,
                                   param_attr=tch.ParamAttr(name="r3_tw")),
            "sub": tch.sub_seq_layer(input=emb2, offsets=offs,
                                     sizes=sizes)}


def seq_slice(tch):
    seq = tch.data_layer(name="g_seq", size=2)
    emb2 = tch.embedding_layer(input=seq, size=4)
    ends = tch.data_layer(name="g_ends", size=1)
    return {"sl": tch.seq_slice_layer(input=emb2, ends=ends)}


def round4(tch):
    img = tch.data_layer(name="r4_img", size=2 * 3 * 4, height=3, width=4)
    a = tch.data_layer(name="r4_a", size=6)
    with tch.mixed_layer(size=4) as m:
        m += tch.slice_projection(input=a, slices=[(0, 2), (4, 6)])
    return {"pr": tch.printer_layer(input=img),
            "rz": tch.resize_layer(input=img, size=12),
            "rot": tch.rotate_layer(input=img),
            "ccn": tch.cross_channel_norm_layer(input=img),
            "m": m}


def round5_image(tch):
    img = tch.data_layer(name="r5_img", size=2 * 4 * 4, height=4, width=4)
    ind = tch.data_layer(name="r5_ind", size=6)
    rois = tch.data_layer(name="r5_rois", size=4)
    w = tch.data_layer(name="r5_w", size=2)
    v = tch.data_layer(name="r5_v", size=6)
    vol = tch.data_layer(name="r5_vol", size=1 * 8)
    c3 = tch.img_conv3d_layer(input=vol, filter_size=2, num_filters=2,
                              num_channels=1)
    return {"cr": tch.crop_layer(input=img, offset=[1, 1], shape=[2, 2],
                                 axis=2),
            "pr": tch.prelu_layer(input=img, channel_shared=True),
            "ssr": tch.scale_sub_region_layer(input=img, indices=ind,
                                              value=3.0),
            "rp": tch.roi_pool_layer(input=img, rois=rois, pooled_width=2,
                                     pooled_height=2, spatial_scale=1.0),
            "lc": tch.linear_comb_layer(weights=w, vectors=v, size=3),
            "p3": tch.img_pool3d_layer(input=c3, pool_size=1)}


def detection(tch):
    img = tch.data_layer(name="det_img", size=3 * 8 * 8, height=8, width=8)
    feat = tch.img_conv_layer(input=img, filter_size=3, num_filters=4,
                              padding=1, num_channels=3)
    pb = tch.priorbox_layer(input=feat, image=img, aspect_ratio=[2.0],
                            variance=[0.1, 0.1, 0.2, 0.2], min_size=[2.0],
                            max_size=[4.0])
    loc = tch.img_conv_layer(input=feat, filter_size=3, num_filters=16,
                             padding=1)
    conf = tch.img_conv_layer(input=feat, filter_size=3, num_filters=12,
                              padding=1)
    gt = tch.data_layer(name="det_gt", size=6)
    det = tch.detection_output_layer(
        input_loc=loc, input_conf=conf, priorbox=pb, num_classes=3,
        keep_top_k=8, nms_top_k=16, confidence_threshold=0.0)
    return {"det": det,
            "mbl": tch.multibox_loss_layer(input_loc=loc, input_conf=conf,
                                           priorbox=pb, label=gt,
                                           num_classes=3),
            "dmap": tch.detection_map_evaluator(input=det, label=gt,
                                                num_classes=3)}


def seq_costs(tch):
    s = tch.data_layer(name="sc_s", size=1)
    km = tch.kmax_seq_score_layer(input=s, beam_size=2)
    msc = tch.data_layer(name="sc_m", size=1)
    lbl = tch.data_layer(name="sc_l", size=1)
    x = tch.data_layer(name="sc_x", size=3)
    y = tch.data_layer(name="sc_y", size=1)
    gold = tch.data_layer(name="sc_g", size=1)
    return {"km": km,
            "lam": tch.lambda_cost(input=msc, score=lbl, NDCG_num=2),
            "cesn": tch.cross_entropy_with_selfnorm(
                input=x, label=y, softmax_selfnorm_alpha=0.1),
            "ceob": tch.cross_entropy_over_beam(input=[tch.BeamInput(
                candidate_scores=s, selected_candidates=km, gold=gold)])}


def sub_nested(tch):
    x = tch.data_layer(name="sn_x", size=2)
    sel = tch.data_layer(name="sn_sel", size=2)
    sn = tch.sub_nested_seq_layer(input=x, selected_indices=sel)
    return {"sn": sn,
            "pool": tch.pooling_layer(input=sn,
                                      pooling_type=tch.SumPooling())}


def mixed_conv(tch):
    img = tch.data_layer(name="mc_img", size=2 * 3 * 3, height=3, width=3)
    with tch.mixed_layer(size=3 * 3 * 3) as m:
        m += tch.conv_projection(input=img, filter_size=1, num_filters=3)
    filt = tch.data_layer(name="mc_f", size=3 * 2 * 1 * 1)
    with tch.mixed_layer(size=3 * 3 * 3) as mo:
        mo += tch.conv_operator(img=img, filter=filt, filter_size=1,
                                num_filters=3, num_channels=2)
    return {"m": m, "mo": mo}


def layer_math(tch):
    lm = sub(tch, "layer_math")
    a = tch.data_layer(name="lm_a", size=3)
    b = tch.data_layer(name="lm_b", size=3)
    return {"c": (a + b) * 2.0 - 1.0, "r": 3.0 - a,
            "e": lm.sqrt(lm.exp(a))}


# --- networks helpers (tests/test_networks_helpers.py) ------------------

def image_blocks(tch):
    img = tch.data_layer(name="nb_img", size=3 * 8 * 8, height=8, width=8)
    return {
        "p1": tch.simple_img_conv_pool(
            input=img, filter_size=3, num_filters=4, pool_size=2,
            pool_stride=2, conv_padding=1, num_channel=3,
            act=tch.ReluActivation()),
        "p2": tch.img_conv_bn_pool(
            input=img, filter_size=3, num_filters=4, pool_size=2,
            pool_stride=2, conv_padding=1, num_channel=3,
            act=tch.ReluActivation()),
        "sep": tch.img_separable_conv(
            input=img, num_channels=3, num_out_channels=6, filter_size=3,
            padding=1, act=tch.ReluActivation())}


def small_vgg(tch):
    img = tch.data_layer(name="vgg_img", size=3 * 32 * 32, height=32,
                         width=32)
    return {"p": tch.small_vgg(input_image=img, num_channels=3,
                               num_classes=10)}


def text_and_gru(tch):
    words = tch.data_layer(name="tx_w", size=12)
    emb = tch.embedding_layer(input=words, size=8)
    conv = tch.sequence_conv_pool(input=emb, context_len=3, hidden_size=10)
    gru_last = tch.last_seq(input=tch.simple_gru(input=emb, size=6))
    bi = tch.bidirectional_gru(input=emb, size=5)
    prob = tch.fc_layer(input=tch.concat_layer(input=[conv, gru_last, bi]),
                        size=2, act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="tx_y", size=2)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def lstm_groups(tch):
    words = tch.data_layer(name="lg_w", size=10)
    emb = tch.embedding_layer(input=words, size=8)
    last = tch.last_seq(input=tch.lstmemory_group(input=emb, size=6,
                                                  name="lg_lstm"))
    bi = tch.bidirectional_lstm(input=emb, size=6)
    prob = tch.fc_layer(input=tch.concat_layer(input=[last, bi]), size=2,
                        act=tch.SoftmaxActivation())
    lbl = tch.data_layer(name="lg_y", size=2)
    return {"cost": tch.classification_cost(input=prob, label=lbl)}


def attention(tch):
    seq = tch.data_layer(name="at_seq", size=6)
    state = tch.data_layer(name="at_state", size=6)
    return {
        "att": tch.simple_attention(encoded_sequence=seq, encoded_proj=seq,
                                    decoder_state=state, name="at_simple"),
        "datt": tch.dot_product_attention(
            encoded_sequence=seq, attended_sequence=seq,
            transformed_state=state, name="at_dot"),
        "matt": tch.multi_head_attention(
            query=state, key=seq, value=seq, key_proj_size=4,
            value_proj_size=4, head_num=2, name="at_multi")}


def evaluators(tch):
    pred = tch.data_layer(name="ev_p", size=3)
    lbl = tch.data_layer(name="ev_y", size=1)
    sc = tch.data_layer(name="ev_s", size=1)
    rel = tch.data_layer(name="ev_r", size=1)
    qid = tch.data_layer(name="ev_q", size=1)
    probs = tch.data_layer(name="ce_p", size=4)
    lab = tch.data_layer(name="ce_y", size=1)
    return {"pr": tch.precision_recall_evaluator(input=pred, label=lbl),
            "pn": tch.pnpair_evaluator(input=sc, label=rel, query_id=qid),
            "ce": tch.ctc_error_evaluator(input=probs, label=lab)}


def recurrent_units(tch):
    import importlib

    units = importlib.import_module(
        tch.__name__.replace("trainer_config_helpers",
                             "trainer.recurrent_units"))
    H = 4
    w = tch.data_layer(name="ru_w", size=6)
    emb = tch.embedding_layer(input=w, size=5)
    lstm = units.LstmRecurrentLayerGroup(
        "ru_lstm", H, "tanh", "tanh", "sigmoid",
        [tch.fc_layer(input=emb, size=H * 4, bias_attr=False)])
    gru = units.GatedRecurrentLayerGroup(
        "ru_gru", H, "tanh", "sigmoid",
        [tch.fc_layer(input=emb, size=H * 3, bias_attr=False)])
    last = tch.concat_layer(input=[tch.last_seq(input=lstm),
                                   tch.last_seq(input=gru)])
    prob = tch.fc_layer(input=last, size=2, act=tch.SoftmaxActivation())
    y = tch.data_layer(name="ru_y", size=2)
    return {"cost": tch.classification_cost(input=prob, label=y)}


# --- feeds ----------------------------------------------------------------

def _feeds():
    r = np.random.RandomState
    f = {}
    rng = r(0)
    f["mixed_full_trans"] = {"mx_in": rng.randn(3, 4).astype(np.float32)}
    f["identity_context"] = {"cx_in": (
        np.arange(12, dtype=np.float32).reshape(4, 3), [_lod([2, 2])])}
    rng = r(1)
    lens = [3, 2, 4, 3]
    f["recurrent_group"] = {
        "rg_word": (rng.randint(0, 10, (sum(lens), 1)).astype(np.int64),
                    [_lod(lens)]),
        "rg_label": rng.randint(0, 3, (4, 1)).astype(np.int64)}
    rng = r(3)
    lens = [3, 5, 2]
    f["recurrent_reverse"] = {"rev_x": (
        (0.5 * rng.randn(sum(lens), 4)).astype(np.float32), [_lod(lens)])}
    rng = r(8)
    lens = [3, 2, 4]
    f["lstm_step_group"] = {
        "r3_w": (rng.randint(0, 8, (sum(lens), 1)).astype(np.int64),
                 [_lod(lens)]),
        "r3_y": rng.randint(0, 3, (3, 1)).astype(np.int64)}
    rng = r(9)
    f["gru_step_group"] = {
        "g_w": (rng.randint(0, 8, (5, 1)).astype(np.int64), [_lod([3, 2])]),
        "g_y": rng.randint(0, 3, (2, 1)).astype(np.int64)}
    rng = r(5)
    f["beam_gen"] = {"bs_dummy": rng.randn(3, 2).astype(np.float32)}
    rng = r(4)
    f["breadth_forward"] = {
        "bw_a": rng.rand(3, 4).astype(np.float32) + 0.5,
        "bw_b": rng.rand(3, 4).astype(np.float32) + 0.5,
        "bw_w": rng.rand(3, 1).astype(np.float32)}
    rng = r(5)
    f["sequence_wrappers"] = {
        "bs_seq": (rng.randint(0, 4, (5, 1)).astype(np.int64),
                   [_lod([2, 3])]),
        "bs_left": rng.rand(4, 1).astype(np.float32),
        "bs_right": rng.rand(4, 1).astype(np.float32),
        "bs_rl": rng.randint(0, 2, (4, 1)).astype(np.float32)}
    lens = [3, 4, 2]
    f["recurrent_layer_train"] = {
        "br_w": (rng.randint(0, 8, (sum(lens), 1)).astype(np.int64),
                 [_lod(lens)]),
        "br_y": rng.randint(0, 3, (3, 1)).astype(np.int64)}
    rng = r(6)
    f["image_structured"] = {
        "bi_img": rng.rand(2, 4 * 36).astype(np.float32),
        "bi_sel": np.array([[0], [1], [0]], np.int64),
        "bi_x1": rng.rand(3, 3).astype(np.float32),
        "bi_x2": rng.rand(3, 3).astype(np.float32)}
    f["crf_ctc"] = {
        "bc_em": (rng.rand(5, 4).astype(np.float32), [_lod([3, 2])]),
        "bc_tag": (rng.randint(0, 4, (5, 1)).astype(np.int64),
                   [_lod([3, 2])]),
        "bc_fr": (rng.rand(5, 6).astype(np.float32), [_lod([3, 2])]),
        "bc_lb": (rng.randint(1, 5, (3, 1)).astype(np.int64),
                  [_lod([2, 1])])}
    rng = r(7)
    f["round2"] = {
        "r2_img": rng.rand(2, 48).astype(np.float32),
        "r2_a": rng.rand(4, 5).astype(np.float32),
        "r2_b": rng.rand(4, 5).astype(np.float32),
        "r2_k": rng.rand(4, 3).astype(np.float32),
        "r2_y": rng.randint(0, 2, (4, 1)).astype(np.int64)}
    rng = r(8)
    f["tensor_subseq"] = {
        "r3_a": rng.rand(3, 3).astype(np.float32),
        "r3_b": rng.rand(3, 4).astype(np.float32),
        "r3_seq": (rng.randint(0, 2, (5, 1)).astype(np.int64),
                   [_lod([2, 3])]),
        "r3_off": np.array([[0], [1]], np.int64),
        "r3_sz": np.array([[1], [2]], np.int64)}
    rng = r(9)
    f["seq_slice"] = {
        "g_seq": (rng.randint(0, 2, (5, 1)).astype(np.int64),
                  [np.array([0, 2, 5], np.int32)]),
        "g_ends": np.array([[1], [2]], np.int64)}
    rng = r(10)
    f["round4"] = {"r4_img": rng.rand(2, 24).astype(np.float32),
                   "r4_a": rng.rand(3, 6).astype(np.float32)}
    rng = r(11)
    f["round5_image"] = {
        "r5_img": rng.rand(2, 32).astype(np.float32),
        "r5_ind": np.array([[1, 1, 1, 2, 1, 2], [2, 2, 2, 3, 2, 3]],
                           np.float32),
        "r5_rois": (np.array([[0, 0, 1, 1], [1, 1, 3, 3], [0, 0, 3, 3]],
                             np.float32), [np.array([0, 2, 3], np.int32)]),
        "r5_w": rng.rand(2, 2).astype(np.float32),
        "r5_v": rng.rand(2, 6).astype(np.float32),
        "r5_vol": rng.rand(2, 8).astype(np.float32)}
    rng = r(13)
    f["detection"] = {
        "det_img": rng.rand(2, 3 * 64).astype(np.float32),
        "det_gt": (np.array([[1, 0.1, 0.1, 0.4, 0.4, 0],
                             [2, 0.5, 0.5, 0.9, 0.9, 0],
                             [1, 0.2, 0.3, 0.7, 0.8, 0]], np.float32),
                   [np.array([0, 2, 3], np.int32)])}
    rng = r(14)
    off = np.array([0, 3, 5], np.int32)
    sv = np.array([[0.1], [0.9], [0.5], [0.3], [0.8]], np.float32)
    f["seq_costs"] = {
        "sc_s": (sv, [off]), "sc_m": (sv, [off]),
        "sc_l": (np.array([[2.0], [0.0], [1.0], [1.0], [0.0]], np.float32),
                 [off]),
        "sc_x": rng.rand(2, 3).astype(np.float32) + 0.1,
        "sc_y": np.array([[0], [2]], np.int64),
        "sc_g": np.array([[1], [0]], np.int64)}
    f["sub_nested"] = {
        "sn_x": (np.arange(18, dtype=np.float32).reshape(9, 2),
                 [np.array([0, 3, 5], np.int32),
                  np.array([0, 2, 3, 5, 6, 9], np.int32)]),
        "sn_sel": np.array([[2, 0], [1, -1]], np.int32)}
    rng = r(15)
    f["mixed_conv"] = {"mc_img": rng.rand(2, 18).astype(np.float32),
                       "mc_f": rng.rand(1, 6).astype(np.float32)}
    f["layer_math"] = {"lm_a": np.full((2, 3), 4.0, np.float32),
                       "lm_b": np.full((2, 3), 2.0, np.float32)}
    rng = r(0)
    f["image_blocks"] = {"nb_img": rng.rand(2, 3 * 64).astype(np.float32)}
    rng = r(1)
    f["small_vgg"] = {"vgg_img": rng.rand(2, 3 * 1024).astype(np.float32)}
    rng = r(2)
    f["text_and_gru"] = {
        "tx_w": (rng.randint(0, 12, (10, 1)).astype(np.int64),
                 [_lod([4, 6])]),
        "tx_y": rng.randint(0, 2, (2, 1)).astype(np.int64)}
    rng = r(3)
    f["lstm_groups"] = {
        "lg_w": (rng.randint(0, 10, (8, 1)).astype(np.int64),
                 [_lod([3, 5])]),
        "lg_y": rng.randint(0, 2, (2, 1)).astype(np.int64)}
    rng = r(4)
    f["attention"] = {
        "at_seq": (rng.rand(7, 6).astype(np.float32), [_lod([3, 4])]),
        "at_state": rng.rand(2, 6).astype(np.float32)}
    y = np.array([[0], [1], [2], [1]], np.int64)
    frames = np.zeros((5, 4), np.float32)
    for t, c in enumerate([1, 3, 2, 2, 3]):
        frames[t, c] = 1.0
    f["evaluators"] = {
        "ev_p": np.eye(3, dtype=np.float32)[y.ravel()] * 0.8 + 0.1,
        "ev_y": y,
        "ev_s": np.array([[0.9], [0.1], [0.8], [0.3]], np.float32),
        "ev_r": np.array([[1], [0], [1], [0]], np.float32),
        "ev_q": np.array([[0], [0], [1], [1]], np.float32),
        "ce_p": (frames, [np.array([0, 5], np.int32)]),
        "ce_y": (np.array([[1], [2]], np.int64),
                 [np.array([0, 2], np.int32)])}
    rng = r(7)
    f["recurrent_units"] = {
        "ru_w": (rng.randint(0, 6, (7, 1)).astype(np.int64),
                 [np.array([0, 3, 7], np.int32)]),
        "ru_y": rng.randint(0, 2, (2, 1)).astype(np.int64)}
    return f


FEEDS = _feeds()
_rng = np.random.RandomState(2)
BEAM_PARAMS = {"bs_wordvec": _rng.randn(5, 5) * 0.7,
               "bs_transtable": _rng.randn(5, 5) * 0.7}

# case -> (build, run_both keyword arguments)
CASES = {
    "mixed_full_trans": (mixed_full_trans, dict(train=("cost", 0.05),
                                                steps=3)),
    "identity_context": (identity_context, {}),
    "recurrent_group": (recurrent_group, dict(train=("cost", 0.1),
                                              steps=3)),
    "recurrent_reverse": (recurrent_reverse, dict(train=("cost", 0.05),
                                                  steps=2)),
    "lstm_step_group": (lstm_step_group, dict(train=("cost", 0.1),
                                              steps=3)),
    "gru_step_group": (gru_step_group, dict(train=("cost", 0.1), steps=3)),
    "beam_gen": (beam_gen, dict(extra=(lambda vs: vs[0].lens_name,),
                                params=BEAM_PARAMS)),
    "breadth_forward": (breadth_forward, {}),
    "sequence_wrappers": (sequence_wrappers, {}),
    "recurrent_layer_train": (recurrent_layer_train,
                              dict(train=("cost", 0.1), steps=3)),
    "image_structured": (image_structured, {}),
    "crf_ctc": (crf_ctc, {}),
    "round2": (round2, {}),
    "tensor_subseq": (tensor_subseq, {}),
    "seq_slice": (seq_slice, {}),
    "round4": (round4, {}),
    "round5_image": (round5_image, {}),
    "detection": (detection, dict(train=("mbl", 0.01), steps=2,
                                  fetch=["det", "mbl"])),
    "seq_costs": (seq_costs, {}),
    "sub_nested": (sub_nested, {}),
    "mixed_conv": (mixed_conv, {}),
    "layer_math": (layer_math, {}),
    "image_blocks": (image_blocks, {}),
    "small_vgg": (small_vgg, dict(rtol=1e-4)),
    "text_and_gru": (text_and_gru, dict(train=("cost", 0.1), steps=3)),
    "lstm_groups": (lstm_groups, dict(train=("cost", 0.1), steps=3)),
    "attention": (attention, {}),
    "evaluators": (evaluators, {}),
    "recurrent_units": (recurrent_units, dict(train=("cost", 0.1),
                                              steps=3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dsl_case_matches_the_jax_package(case):
    build, kw = CASES[case]
    run_both(build, FEEDS[case], **kw)


def test_detection_map_of_the_port_is_the_jax_packages():
    """The detection case's mAP evaluator (an op of the test clone in a
    training config) runs forward on both sides: same value."""
    run_both(detection, FEEDS["detection"], fetch=["dmap"])


def test_config_parser_utils_build_the_same_programs():
    """config_parser_utils.parse_network_config / parse_optimizer_config
    and trainer.config_parser.parse_config through both packages."""
    from torch_legacy import SIDES, fresh_names

    progs, settings = {}, {}
    for side, _fluid, tch, _topo in SIDES:
        cpu = sub(tch, "config_parser_utils")

        def netconf():
            x = tch.data_layer(name="cpn_x", size=4)
            tch.outputs(tch.fc_layer(input=x, size=2,
                                     act=tch.SoftmaxActivation()))

        def optconf():
            tch.settings(batch_size=8, learning_rate=0.5,
                         learning_method=tch.AdamOptimizer())

        with fresh_names():
            progs[side] = cpu.parse_network_config(netconf)
        settings[side] = cpu.parse_optimizer_config(optconf)
    assert_same_program(progs["jax"].main_program,
                        progs["torch"].main_program)
    for side in settings:
        assert settings[side]["batch_size"] == 8
        assert settings[side]["learning_rate"] == 0.5


def test_build_both_names_alike():
    both = build_both(mixed_full_trans)
    jt, tt = both["jax"][0], both["torch"][0]
    assert sorted(jt.var_of) == sorted(tt.var_of)
