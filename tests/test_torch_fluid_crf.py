"""The CRF ops (linear_chain_crf, crf_decoding, chunk_eval,
precision_recall), the learning-rate schedules and the Accuracy and
ChunkEvaluator evaluators of the port against the JAX package on the
CPU, on the same seeded inputs.

Tolerances: the CRF loss, Alpha, EmissionExps, TransitionExps and the
Emission / Transition gradients within rtol 1e-5 (atol 1e-5: log-space
sums of O(1) terms); decoded paths, chunk counts and evaluator counts
exactly equal; chunk precision / recall / F1 and precision_recall's
metrics within 1e-6; learning rates within rtol 1e-6 (one f32 pow or
exp of the same operands)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_fluid_lrn_zoo import vjp_both
from test_torch_fluid_ops import assert_same, run_both

torch.set_num_threads(2)

R = np.random.RandomState(0)


def offsets(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


# ragged batches, each with at least one length-1 sequence
LENGTHS = {"mixed": [3, 1, 5, 2], "single_token": [1], "ones": [1, 1, 1],
           "long_and_one": [7, 1]}
CRF_OUTS = ("LogLikelihood", "Alpha", "EmissionExps", "TransitionExps")


def crf_inputs(lens, n=4, seed=0):
    rng = np.random.RandomState(seed)
    total = sum(lens)
    return {"Emission": [rng.randn(total, n).astype(np.float32)],
            "Transition": [rng.randn(n + 2, n).astype(np.float32) * 0.5],
            "Label": [rng.randint(0, n, (total, 1)).astype(np.int64)]}


@pytest.mark.parametrize("case", sorted(LENGTHS))
def test_linear_chain_crf_forward_and_gradients(case):
    lens = LENGTHS[case]
    ins = crf_inputs(lens)
    lods = {"Emission": offsets(lens)}
    j, t, _ = run_both("linear_chain_crf", ins, {}, lods=lods,
                       outs=CRF_OUTS, keep=CRF_OUTS)
    assert_same(j, t, slots=CRF_OUTS, atol=1e-5, rtol=1e-5)
    jy, ty, jg, tg = vjp_both("linear_chain_crf", ins, {},
                              ["Emission", "Transition"], "LogLikelihood",
                              lods=lods)
    np.testing.assert_allclose(ty, jy, rtol=1e-5, atol=1e-5)
    for a, b in zip(jg, tg):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def test_linear_chain_crf_skips_outputs_nothing_reads():
    """Alpha and the *Exps outputs are computed only when read."""
    ins = crf_inputs([2, 3])
    _, t, _ = run_both("linear_chain_crf", ins, {},
                       lods={"Emission": offsets([2, 3])},
                       outs=CRF_OUTS, keep=("LogLikelihood",))
    assert sorted(t) == ["LogLikelihood"]


def _tied(lens, n):
    """Integer-valued emissions and transitions in {0, 1}: most Viterbi
    maxima and end scores tie."""
    rng = np.random.RandomState(3)
    total = sum(lens)
    return {"Emission": [rng.randint(0, 2, (total, n)).astype(np.float32)],
            "Transition": [rng.randint(0, 2, (n + 2, n)).astype(
                np.float32)]}


DECODE = {
    "random": lambda lens: dict(crf_inputs(lens), Label=None),
    "ties": lambda lens: _tied(lens, 4),
    "all_equal": lambda lens: {
        "Emission": [np.zeros((sum(lens), 4), np.float32)],
        "Transition": [np.zeros((6, 4), np.float32)]},
}


@pytest.mark.parametrize("with_label", [False, True])
@pytest.mark.parametrize("kind", sorted(DECODE))
def test_crf_decoding_paths_equal(kind, with_label):
    lens = LENGTHS["mixed"]
    ins = {k: v for k, v in DECODE[kind](lens).items() if v is not None}
    if with_label:
        ins["Label"] = [np.random.RandomState(4).randint(
            0, 4, (sum(lens), 1)).astype(np.int64)]
    j, t, _ = run_both("crf_decoding", ins, {},
                       lods={"Emission": offsets(lens)},
                       outs=("ViterbiPath",))
    np.testing.assert_array_equal(t["ViterbiPath"][0], j["ViterbiPath"][0])
    np.testing.assert_array_equal(t["ViterbiPath@LOD0"][0],
                                  j["ViterbiPath@LOD0"][0])
    if kind == "all_equal" and not with_label:
        # every path ties: the first maximum everywhere is label 0
        assert not t["ViterbiPath"][0].any()


CHUNK = {
    # scheme: (num_chunk_types, tags per type)
    "IOB": (3, 2), "IOE": (3, 2), "IOBES": (2, 4), "plain": (4, 1),
}


@pytest.mark.parametrize("excluded", [None, [1]])
@pytest.mark.parametrize("scheme", sorted(CHUNK))
def test_chunk_eval_counts(scheme, excluded):
    types, ntag = CHUNK[scheme]
    lens = [6, 1, 9, 4, 12]
    rng = np.random.RandomState(5)
    # labels past num_types * ntag are "outside"
    label = rng.randint(0, types * ntag + 1, sum(lens))
    infer = np.where(rng.rand(sum(lens)) < 0.7, label,
                     rng.randint(0, types * ntag + 1, sum(lens)))
    attrs = dict(chunk_scheme=scheme, num_chunk_types=types,
                 excluded_chunk_types=excluded)
    j, t, _ = run_both("chunk_eval",
                       {"Inference": [infer.reshape(-1, 1).astype(np.int64)],
                        "Label": [label.reshape(-1, 1).astype(np.int64)]},
                       attrs, lods={"Label": offsets(lens)})
    for slot in ("NumInferChunks", "NumLabelChunks", "NumCorrectChunks"):
        assert int(t[slot][0][0]) == int(j[slot][0][0]), slot
    assert int(t["NumLabelChunks"][0][0]) > 0
    assert_same(j, t, slots=("Precision", "Recall", "F1-Score"), atol=1e-6,
                rtol=1e-6)


@pytest.mark.parametrize("extras", ["plain", "weights_and_states"])
def test_precision_recall(extras):
    C, N = 5, 60
    rng = np.random.RandomState(6)
    ins = {"Indices": [rng.randint(0, C, (N, 1)).astype(np.int64)],
           "Labels": [rng.randint(0, C, (N, 1)).astype(np.int64)]}
    if extras != "plain":
        ins["Weights"] = [rng.rand(N, 1).astype(np.float32)]
        ins["StatesInfo"] = [rng.randint(0, 9, (C, 4)).astype(np.float32)]
    j, t, _ = run_both("precision_recall", ins, dict(class_number=C))
    assert_same(j, t, atol=1e-6, rtol=1e-6)


# --- learning-rate schedules --------------------------------------------

SCHEDULES = {
    "exponential": lambda d, gs, on: d.exponential_decay(
        0.1, gs, decay_steps=2, decay_rate=0.5, staircase=on),
    "natural_exp": lambda d, gs, on: d.natural_exp_decay(
        0.1, gs, decay_steps=2, decay_rate=0.5, staircase=on),
    "inverse_time": lambda d, gs, on: d.inverse_time_decay(
        0.1, gs, decay_steps=2, decay_rate=0.5, staircase=on),
    # polynomial's switch is `cycle`
    "polynomial": lambda d, gs, on: d.polynomial_decay(
        0.1, gs, decay_steps=3, end_learning_rate=0.01, power=2.0,
        cycle=on),
    "piecewise": lambda d, gs, on: d.piecewise_decay(
        gs, boundaries=[1.5, 3], values=[0.1, 0.05, 0.01]),
}


@pytest.mark.parametrize("staircase", [False, True])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_learning_rate_schedules(schedule, staircase):
    """5 SGD steps of a small regression with the schedule's rate on a
    force_cpu global step that the optimizer advances: the rate, the
    loss and the parameters of every step equal the JAX package's."""
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(input=x, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        gs = fluid.layers.create_global_var(
            shape=[1], value=0, dtype="float32", force_cpu=True,
            persistable=True)
        lr = SCHEDULES[schedule](fluid.learning_rate_decay, gs, staircase)
        fluid.optimizer.SGD(learning_rate=lr, global_step=gs).minimize(loss)
        return dict(loss=loss, lr=lr, gs=gs)

    pair = tp.FluidPair(build)
    rng = np.random.RandomState(7)
    feed = dict(x=rng.randn(6, 3).astype(np.float32),
                y=rng.randn(6, 1).astype(np.float32))
    rates = []
    for step in range(5):
        j, t = pair.run(feed, ["lr", "loss", "gs"])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
        np.testing.assert_allclose(t[1], j[1], rtol=1e-6)
        assert float(t[2][0]) == float(j[2][0]) == step + 1
        rates.append(float(t[0][0]))
    assert len(set(rates)) > 1
    assert max(pair.state_diff().values()) < 1e-6


# --- evaluators ----------------------------------------------------------

def _eval_both(pair, key, fn):
    with tp.JF.scope_guard(pair.jscope):
        j = fn(pair.jvars[key], pair.jexe)
    with tp.TF.scope_guard(pair.tscope):
        t = fn(pair.tvars[key], pair.texe)
    return np.asarray(j), np.asarray(t)


def test_accuracy_evaluator_across_reset():
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        lbl = fluid.layers.data(name="lbl", shape=[1], dtype="int64")
        pred = fluid.layers.fc(input=x, size=3, act="softmax")
        ev = fluid.evaluator.Accuracy(input=pred, label=lbl)
        return dict(ev=ev, acc=ev.metrics[0])

    pair = tp.FluidPair(build)
    rng = np.random.RandomState(8)
    batches = [dict(x=rng.randn(n, 4).astype(np.float32),
                    lbl=rng.randint(0, 3, (n, 1)).astype(np.int64))
               for n in (5, 7, 4, 6)]
    _eval_both(pair, "ev", lambda ev, exe: ev.reset(exe))
    for phase in (batches[:3], batches[3:]):
        for feed in phase:
            j, t = pair.run(feed, ["acc"])
            np.testing.assert_allclose(t[0], j[0], rtol=1e-6)
        j, t = _eval_both(pair, "ev", lambda ev, exe: ev.eval(exe))
        assert float(t) == float(j)
        assert 0.0 <= float(t) <= 1.0
        _eval_both(pair, "ev", lambda ev, exe: ev.reset(exe))
    j, t = _eval_both(pair, "ev", lambda ev, exe: ev.eval(exe))
    assert float(t) == float(j) == 0.0


def test_chunk_evaluator_across_reset():
    def build(fluid, resnet):
        inf = fluid.layers.data(name="inf", shape=[1], dtype="int64",
                                lod_level=1)
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        ev = fluid.evaluator.ChunkEvaluator(
            input=inf, label=lab, chunk_scheme="IOB", num_chunk_types=2)
        return dict(ev=ev, p=ev.metrics[0], r=ev.metrics[1],
                    f1=ev.metrics[2])

    pair = tp.FluidPair(build)
    rng = np.random.RandomState(9)

    def batch(lens):
        label = rng.randint(0, 5, sum(lens))
        infer = np.where(rng.rand(sum(lens)) < 0.6, label,
                         rng.randint(0, 5, sum(lens)))
        lod = [offsets(lens)]
        return dict(inf=(infer.reshape(-1, 1).astype(np.int64), lod),
                    lab=(label.reshape(-1, 1).astype(np.int64), lod))

    _eval_both(pair, "ev", lambda ev, exe: ev.reset(exe))
    for lens_list in ([[5, 1, 8], [3, 3]], [[9, 2, 1, 4]]):
        for lens in lens_list:
            j, t = pair.run(batch(lens), ["p", "r", "f1"])
            for a, b in zip(j, t):
                np.testing.assert_allclose(b, a, atol=1e-6)
        j, t = _eval_both(pair, "ev", lambda ev, exe: ev.eval(exe))
        np.testing.assert_allclose(t, j, atol=1e-7)
        assert t[0] > 0
        _eval_both(pair, "ev", lambda ev, exe: ev.reset(exe))
        assert not any(np.asarray(tp.TF.as_numpy(pair.tscope.get(s.name)))
                       .any() for s in pair.tvars["ev"].states)
