"""The book's semantic role labelling (db_lstm + linear_chain_crf +
crf_decoding + ChunkEvaluator, with exponential_decay on a force_cpu
global step and a per-parameter learning rate on the CRF transitions)
through the port's Executor against the JAX package's, at
tests/test_label_semantic_roles.py's widths and synthetic corpus.

Tolerances: losses within rtol 1e-5 and parameters within atol 1e-5
after 3 SGD steps from the same JAX startup weights (reduction order
only); the decoded paths, the chunk counts of every step and the
evaluator's state exactly equal; precision / recall / F1 within 1e-6."""

import math

import numpy as np
import torch

import torch_parity as tp
from test_label_semantic_roles import synthetic_srl, to_feed

torch.set_num_threads(2)

WORD_DICT_LEN = 30
LABEL_DICT_LEN = 5  # B-0 I-0 B-1 I-1 O
PRED_LEN = 10
MARK_DICT_LEN = 2
WORD_DIM = 8
MARK_DIM = 4
HIDDEN = 16
DEPTH = 4
MIX_HIDDEN_LR = 1e-3
SLOTS = ("word_data", "verb_data", "ctx_n2_data", "ctx_n1_data",
         "ctx_0_data", "ctx_p1_data", "ctx_p2_data", "mark_data")


def db_lstm(fluid, word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2,
            mark):
    """tests/test_label_semantic_roles.py's db_lstm over `fluid`."""
    pd = fluid.layers
    predicate_embedding = pd.embedding(
        input=predicate, size=[PRED_LEN, WORD_DIM], dtype="float32",
        param_attr="vemb")
    mark_embedding = pd.embedding(input=mark, size=[MARK_DICT_LEN, MARK_DIM],
                                  dtype="float32")
    emb_layers = [
        pd.embedding(size=[WORD_DICT_LEN, WORD_DIM], input=x,
                     param_attr=fluid.ParamAttr(name="emb", trainable=False))
        for x in (word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2)]
    emb_layers += [predicate_embedding, mark_embedding]
    hidden_0 = pd.sums(input=[pd.fc(input=e, size=HIDDEN)
                              for e in emb_layers])
    lstm_0 = pd.dynamic_lstm(input=hidden_0, size=HIDDEN,
                             candidate_activation="relu",
                             gate_activation="sigmoid",
                             cell_activation="sigmoid")[0]
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, DEPTH):
        mix_hidden = pd.sums(input=[pd.fc(input=input_tmp[0], size=HIDDEN),
                                    pd.fc(input=input_tmp[1], size=HIDDEN)])
        lstm = pd.dynamic_lstm(input=mix_hidden, size=HIDDEN,
                               candidate_activation="relu",
                               gate_activation="sigmoid",
                               cell_activation="sigmoid",
                               is_reverse=(i % 2) == 1)[0]
        input_tmp = [mix_hidden, lstm]
    return pd.sums(input=[pd.fc(input=input_tmp[0], size=LABEL_DICT_LEN),
                          pd.fc(input=input_tmp[1], size=LABEL_DICT_LEN)])


def build(fluid, resnet):
    pd = fluid.layers
    feats = [pd.data(name=n, shape=[1], dtype="int64", lod_level=1)
             for n in SLOTS]
    feature_out = db_lstm(fluid, *feats)
    target = pd.data(name="target", shape=[1], dtype="int64", lod_level=1)
    crf_cost = pd.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw", learning_rate=MIX_HIDDEN_LR))
    avg_cost = pd.mean(x=crf_cost)
    global_step = pd.create_global_var(shape=[1], value=0, dtype="float32",
                                       force_cpu=True, persistable=True)
    fluid.optimizer.SGD(
        learning_rate=fluid.learning_rate_decay.exponential_decay(
            learning_rate=0.01, global_step=global_step,
            decay_steps=100000, decay_rate=0.5, staircase=True),
        global_step=global_step).minimize(avg_cost)
    crf_decode = pd.crf_decoding(input=feature_out,
                                 param_attr=fluid.ParamAttr(name="crfw"))
    ev = fluid.evaluator.ChunkEvaluator(
        input=crf_decode, label=target, chunk_scheme="IOB",
        num_chunk_types=int(math.ceil((LABEL_DICT_LEN - 1) / 2.0)))
    p, r, f1 = ev.metrics
    return dict(loss=avg_cost, path=crf_decode, p=p, r=r, f1=f1, ev=ev,
                step=global_step)


def test_srl_trains_decodes_and_evaluates_like_the_jax_executor():
    pair = tp.FluidPair(build)
    feed = to_feed(synthetic_srl(np.random.RandomState(0), 12))
    for ev, scope, module in ((pair.jvars["ev"], pair.jscope, tp.JF),
                              (pair.tvars["ev"], pair.tscope, tp.TF)):
        with module.scope_guard(scope):
            ev.reset(None)
    losses = []
    for step in range(3):
        j, t = pair.run(feed, ["loss", "path", "p", "r", "f1", "step"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5)
        np.testing.assert_array_equal(t[1], j[1])
        np.testing.assert_allclose(t[2:5], j[2:5], atol=1e-6)
        assert float(t[5][0]) == float(j[5][0]) == step + 1
        losses.append(float(t[0][0]))
    assert losses[-1] < losses[0]
    diff = pair.state_diff()
    params = {p.name for p in pair.tmain.global_block().all_parameters()}
    bad = sorted((d, n) for n, d in diff.items() if n in params and d > 1e-5)
    assert not bad, bad[-3:]
    # the chunk counts the evaluator accumulated are the same integers
    for jv, tv in zip(pair.jvars["ev"].states, pair.tvars["ev"].states):
        a = np.asarray(pair.jscope.get(jv.name))
        b = tp.TF.as_numpy(pair.tscope.get(tv.name))
        assert int(a.reshape(-1)[0]) == int(b.reshape(-1)[0]) > 0
    with tp.JF.scope_guard(pair.jscope):
        jm = pair.jvars["ev"].eval(pair.jexe)
    with tp.TF.scope_guard(pair.tscope):
        tm = pair.tvars["ev"].eval(pair.texe)
    np.testing.assert_allclose(tm, jm, atol=1e-7)
