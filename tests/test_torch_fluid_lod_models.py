"""Ragged (LoD) models trained through the port's Fluid executor against
the JAX package's on the CPU: the book's sentiment nets, the CRNN OCR
model and the benchmark/paddle LSTM program, built by each package's
fluid API and trained from the same JAX startup weights (`FluidPair`),
fed `(data, [offsets])` pairs or DataFeeder feeds.

Lengths come from a seed and include a sequence of length 1 and a
longest sequence whose length is no power of two (the JAX executor
rounds its time extent up to one; the port takes it exactly; the masks
make the outputs the same). Every step reuses one feed, so JAX compiles
once.

Tolerances: f32 losses within rtol 1e-4 and parameters within atol 1e-5
after 3 steps (reduction order only); the bf16 AMP LSTM's losses within
rtol 2e-2 and its parameters within atol 2e-2 (bf16 keeps ~3
significant digits, and the two packages round the recurrent GEMM's sum
with the gate input differently)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import JF, TF
from paddle_tpu.models import ocr_crnn as JC
from paddle_tpu_torch.models import ocr_crnn as TC

torch.set_num_threads(2)

VOCAB = 40
LENS = [3, 1, 7, 5, 2, 6]  # a length 1; longest 7, no power of two


def words_feed(seed=0, lens=LENS, vocab=VOCAB, classes=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, vocab, (sum(lens), 1)).astype(np.int64)
    lod = np.cumsum([0] + list(lens)).astype(np.int32)
    labels = rng.randint(0, classes, (len(lens), 1)).astype(np.int64)
    return {"words": (toks, [lod]), "label": labels}


# --- the book's sentiment nets (tests/test_understand_sentiment.py) -------

def convolution_net(fluid, data, label, input_dim, class_dim=2, emb_dim=8,
                    hid_dim=8):
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim])
    conv_3 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=3, act="tanh",
        pool_type="sqrt")
    conv_4 = fluid.nets.sequence_conv_pool(
        input=emb, num_filters=hid_dim, filter_size=4, act="tanh",
        pool_type="sqrt")
    prediction = fluid.layers.fc(input=[conv_3, conv_4], size=class_dim,
                                 act="softmax")
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    return fluid.layers.mean(x=cost)


def stacked_lstm_net(fluid, data, label, input_dim, class_dim=2, emb_dim=8,
                     hid_dim=8, stacked_num=3):
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim])
    fc1 = fluid.layers.fc(input=emb, size=hid_dim)
    lstm1, cell1 = fluid.layers.dynamic_lstm(input=fc1, size=hid_dim)
    inputs = [fc1, lstm1]
    for i in range(2, stacked_num + 1):
        fc = fluid.layers.fc(input=inputs, size=hid_dim)
        lstm, cell = fluid.layers.dynamic_lstm(
            input=fc, size=hid_dim, is_reverse=(i % 2) == 0)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(input=inputs[0], pool_type="max")
    lstm_last = fluid.layers.sequence_pool(input=inputs[1], pool_type="max")
    prediction = fluid.layers.fc(input=[fc_last, lstm_last],
                                 size=class_dim, act="softmax")
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    return fluid.layers.mean(x=cost)


def sentiment(net, opt):
    def build(fluid, resnet):
        data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        loss = net(fluid, data, label, input_dim=VOCAB)
        opt(fluid).minimize(loss)
        return dict(loss=loss)
    return build


def bench_lstm(fluid, vocab=VOCAB, emb=8, hidden=8, layers_n=2,
               peepholes=True):
    """bench.py:800-850's program at small widths."""
    words = fluid.layers.data(name="words", shape=[1], dtype="int64",
                              lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = fluid.layers.embedding(input=words, size=[vocab, emb])
    for _ in range(layers_n):
        proj = fluid.layers.fc(input=x, size=hidden * 4)
        x, _ = fluid.layers.dynamic_lstm(input=proj, size=hidden * 4,
                                         use_peepholes=peepholes)
    last = fluid.layers.sequence_last_step(input=x)
    predict = fluid.layers.fc(input=last, size=2, act="softmax")
    return fluid.layers.mean(
        x=fluid.layers.cross_entropy(input=predict, label=label))


def bench_lstm_build(fluid, resnet):
    loss = bench_lstm(fluid)
    fluid.optimizer.Adam(learning_rate=2e-3).minimize(loss)
    return dict(loss=loss)


def train(pair, feed, steps=3):
    jl, tl = [], []
    for _ in range(steps):
        j, t = pair.run(feed, ["loss"])
        jl.append(float(j[0].reshape(-1)[0]))
        tl.append(float(t[0].reshape(-1)[0]))
    return jl, tl


def assert_trained_alike(pair, jl, tl, rtol=1e-4, atol=1e-5):
    np.testing.assert_allclose(tl, jl, rtol=rtol)
    diff = pair.state_diff()
    worst = max(diff[n] for n in pair.model_state_names())
    assert worst <= atol, sorted(diff.items(), key=lambda kv: -kv[1])[:4]
    assert all(np.isfinite(jl))


SENTIMENT = {
    "convolution_net_momentum": (
        convolution_net,
        lambda f: f.optimizer.Momentum(learning_rate=0.1, momentum=0.9)),
    "stacked_lstm_net_sgd": (
        stacked_lstm_net, lambda f: f.optimizer.SGD(learning_rate=0.5)),
}


@pytest.mark.parametrize("case", sorted(SENTIMENT))
def test_sentiment_nets_train_alike(case):
    net, opt = SENTIMENT[case]
    pair = tp.FluidPair(sentiment(net, opt))
    jl, tl = train(pair, words_feed())
    assert_trained_alike(pair, jl, tl)


def test_bench_lstm_program_trains_alike_under_adam():
    pair = tp.FluidPair(bench_lstm_build)
    jl, tl = train(pair, words_feed(1))
    assert_trained_alike(pair, jl, tl)


def test_bench_lstm_program_trains_alike_under_amp():
    pair = tp.FluidPair(bench_lstm_build, amp=True)
    jl, tl = train(pair, words_feed(1))
    assert_trained_alike(pair, jl, tl, rtol=2e-2, atol=2e-2)


# --- the CRNN (paddle_tpu/models/ocr_crnn.py) -----------------------------

NC = 5


def crnn_build(width=32, hidden=8, decode=False, train=True):
    def build(fluid, resnet):
        crnn = TC if fluid is TF else JC
        img = fluid.layers.data(name="img", shape=[1, 8, width],
                                dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], dtype="int64",
                                lod_level=1)
        loss, logits = crnn.crnn_ctc(img, lab, num_classes=NC,
                                     hidden=hidden)
        out = dict(loss=loss, logits=logits)
        if decode:
            out["decoded"] = crnn.greedy_decode(logits, NC)
            out["test_program"] = fluid.default_main_program().clone(
                for_test=True)
        if train:
            fluid.optimizer.Momentum(learning_rate=0.05,
                                     momentum=0.9).minimize(loss)
        return out
    return build


def ocr_feed(seed=0, batch=4, width=32, lens=(1, 3, 4, 2)):
    rng = np.random.RandomState(seed)
    img = rng.rand(batch, 1, 8, width).astype(np.float32)
    lab = rng.randint(0, NC, (sum(lens), 1)).astype(np.int64)
    lod = np.cumsum([0] + list(lens)).astype(np.int32)
    return {"img": img, "lab": (lab, [lod])}


def test_crnn_ctc_trains_alike():
    pair = tp.FluidPair(crnn_build(decode=True))
    feed = ocr_feed()
    jl, tl = train(pair, feed)
    assert_trained_alike(pair, jl, tl)
    # the greedy decode of the trained weights: the same tokens (the
    # kept prefix of the compacted buffer is what the offsets describe)
    j, t = pair.run({"img": feed["img"]}, ["decoded"], test=True)
    np.testing.assert_array_equal(t[0], j[0])


def test_graph_produced_lod_not_truncated_by_fed_bucket():
    """im2sequence emits more steps (24 per image) than any fed sequence
    (2): the recurrences' and CTC's extent must follow the
    graph-produced offsets, not the fed maximum (tests/
    test_mobilenet_ocr.py's case). The JAX package intends the same
    (its _seq_T prefers constant offsets), but under jit its
    im2sequence offsets are traced values, so its executor falls back
    to the fed bucket (8) and cuts the scan; under jax.disable_jit they
    are constants and it computes the full extent: the port is held
    against that run, and the last columns must reach the logits."""
    import jax

    pair = tp.FluidPair(crnn_build(width=96, hidden=8, train=False))
    rng = np.random.RandomState(3)
    base = 0.05 * rng.rand(2, 1, 8, 96).astype(np.float32)
    labels = (np.asarray([0, 1, 1, 2], np.int64).reshape(-1, 1),
              [np.asarray([0, 2, 4], np.int32)])
    bumped = base.copy()
    bumped[:, :, :, -3:] += 1.0  # signal ONLY in the last columns
    outs = []
    for img in (base, bumped):
        with jax.disable_jit():
            j, t = pair.run({"img": img, "lab": labels}, ["logits", "loss"])
        for a, b in zip(j, t):
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5)
        outs.append(t[0])
    assert outs[0].shape[0] == 2 * 24, outs[0].shape
    assert not np.allclose(outs[0][20:24], outs[1][20:24])


# --- DataFeeder ------------------------------------------------------------

def test_data_feeder_feeds_train_alike():
    """Each package's DataFeeder packs the same rows; the port's keeps
    int64 ids (the JAX package narrows them to int32) and the same
    offsets, and both train the stacked LSTM net alike from them."""
    rng = np.random.RandomState(4)
    rows = [(list(rng.randint(0, VOCAB, n)), [int(rng.randint(0, 2))])
            for n in LENS]
    pair = tp.FluidPair(sentiment(stacked_lstm_net,
                                  lambda f: f.optimizer.SGD(0.5)))
    jfeed = JF.DataFeeder(["words", "label"], program=pair.jmain).feed(rows)
    tfeed = TF.DataFeeder(["words", "label"], program=pair.tmain).feed(rows)
    (jt, jlod), (tt, tlod) = jfeed["words"], tfeed["words"]
    assert tt.dtype == np.int64 and tt.shape == (sum(LENS), 1)
    np.testing.assert_array_equal(tt, jt)
    assert tlod == jlod
    np.testing.assert_array_equal(tfeed["label"], jfeed["label"])
    for _ in range(3):
        with JF.scope_guard(pair.jscope):
            j = pair.jexe.run(pair.jmain, feed=jfeed,
                              fetch_list=[pair.jvars["loss"]])
        with TF.scope_guard(pair.tscope):
            t = pair.texe.run(pair.tmain, feed=tfeed,
                              fetch_list=[pair.tvars["loss"]])
        np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    assert max(pair.state_diff()[n]
               for n in pair.model_state_names()) <= 1e-5


def test_run_repeated_scans_ragged_feeds():
    """run_repeated(scan_feeds=True) slices a ragged feed's data per
    step and keeps its offsets, as the JAX package's scan does."""
    pair = tp.FluidPair(bench_lstm_build)
    feeds = [words_feed(s) for s in (5, 6)]
    lod = feeds[0]["words"][1]
    scanned = {"words": (np.stack([f["words"][0] for f in feeds]), lod),
               "label": np.stack([f["label"] for f in feeds])}
    with JF.scope_guard(pair.jscope):
        j = pair.jexe.run_repeated(pair.jmain, feed=scanned, steps=2,
                                   scan_feeds=True,
                                   fetch_list=[pair.jvars["loss"]])
    with TF.scope_guard(pair.tscope):
        t = pair.texe.run_repeated(pair.tmain, feed=scanned, steps=2,
                                   scan_feeds=True,
                                   fetch_list=[pair.tvars["loss"]])
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    assert max(pair.state_diff()[n]
               for n in pair.model_state_names()) <= 1e-5


def test_lod_tensor_objects_feed_like_pairs():
    """An object with `.data` and `.lod()` feeds as its (data, lod)
    pair does."""
    class LoD(object):
        def __init__(self, data, lod):
            self.data, self._lod = data, lod

        def lod(self):
            return self._lod

    feed = words_feed(2)
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        loss = bench_lstm(TF)
    exe = TF.Executor(TF.CPUPlace())
    with TF.scope_guard(TF.Scope()):
        exe.run(startup)
        a = exe.run(main, feed=feed, fetch_list=[loss])[0]
        b = exe.run(main, feed=dict(feed, words=LoD(*feed["words"])),
                    fetch_list=[loss])[0]
    np.testing.assert_array_equal(a, b)
