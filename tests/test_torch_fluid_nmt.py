"""The book's seq2seq machine translation (tests/test_machine_translation.py:
topology, widths and Adagrad) through the port's Fluid against the JAX
package's on the CPU: 3 training steps alike, the beam decode alike
(ids, lengths, the fetched counter; scores close), and a decode program
saved by either package loads in the other and decodes the same.

Encoder: embedding -> fc(4H, tanh) -> dynamic_lstm(4H) ->
sequence_last_step. Training decoder: a DynamicRNN over the target
words, its memory booted from the encoder's context, fc([word, state],
tanh) -> fc(softmax), cross_entropy -> mean. Decoder: a While loop over
tensor arrays, sequence_expand over the beam parents, topk ->
beam_search, then beam_search_decode. Data: the JAX test's synthetic
reverse-copy corpus (`synthetic_wmt`) from RandomState seeds.

Bars: losses within rtol 1e-4, parameters within atol 1e-5 (under the
book's Adagrad(0.2) the losses only: see OPTIMIZERS); ids, lengths and
counters exact; scores within rtol 1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import JF, TF
from test_torch_fluid_lod_models import assert_trained_alike, train

torch.set_num_threads(2)

DICT, WORD, HIDDEN, BATCH, MAX_LEN, BEAM = 40, 16, 32, 8, 6, 2
START, END = 1, 2


def encoder(fluid):
    pd = fluid.layers
    src = pd.data(name="src_word_id", shape=[1], dtype="int64", lod_level=1)
    emb = pd.embedding(input=src, size=[DICT, WORD], dtype="float32",
                       param_attr=fluid.ParamAttr(name="vemb"))
    fc1 = pd.fc(input=emb, size=HIDDEN * 4, act="tanh")
    hidden, _ = pd.dynamic_lstm(input=fc1, size=HIDDEN * 4)
    return pd.sequence_last_step(input=hidden)


def train_build(fluid, resnet, opt=("Adagrad", 0.2)):
    pd = fluid.layers
    context = encoder(fluid)
    trg = pd.data(name="target_language_word", shape=[1], dtype="int64",
                  lod_level=1)
    trg_emb = pd.embedding(input=trg, size=[DICT, WORD], dtype="float32",
                           param_attr=fluid.ParamAttr(name="vemb"))
    rnn = pd.DynamicRNN()
    with rnn.block():
        word = rnn.step_input(trg_emb)
        pre_state = rnn.memory(init=context)
        state = pd.fc(input=[word, pre_state], size=HIDDEN, act="tanh")
        score = pd.fc(input=state, size=DICT, act="softmax")
        rnn.update_memory(pre_state, state)
        rnn.output(score)
    label = pd.data(name="target_language_next_word", shape=[1],
                    dtype="int64", lod_level=1)
    loss = pd.mean(x=pd.cross_entropy(input=rnn(), label=label))
    getattr(fluid.optimizer, opt[0])(learning_rate=opt[1]).minimize(loss)
    return dict(loss=loss)


def decode_build(fluid, resnet):
    pd = fluid.layers
    context = encoder(fluid)
    array_len = pd.fill_constant(shape=[1], dtype="int64", value=MAX_LEN)
    counter = pd.zeros(shape=[1], dtype="int64", force_cpu=True)
    state_array = pd.create_array("float32")
    pd.array_write(context, array=state_array, i=counter)
    ids_array = pd.create_array("int64")
    scores_array = pd.create_array("float32")
    init_ids = pd.data(name="init_ids", shape=[1], dtype="int64",
                       lod_level=2)
    init_scores = pd.data(name="init_scores", shape=[1], dtype="float32",
                          lod_level=2)
    pd.array_write(init_ids, array=ids_array, i=counter)
    pd.array_write(init_scores, array=scores_array, i=counter)
    cond = pd.less_than(x=counter, y=array_len)
    w = pd.While(cond=cond)
    with w.block():
        pre_ids = pd.array_read(array=ids_array, i=counter)
        pre_state = pd.array_read(array=state_array, i=counter)
        pre_score = pd.array_read(array=scores_array, i=counter)
        expanded = pd.sequence_expand(pre_state, pre_score)
        emb = pd.embedding(input=pre_ids, size=[DICT, WORD], dtype="float32",
                           param_attr=fluid.ParamAttr(name="vemb"))
        state = pd.fc(input=[emb, expanded], size=HIDDEN, act="tanh")
        score = pd.fc(input=state, size=DICT, act="softmax")
        top_scores, top_ids = pd.topk(score, k=10)
        sel_ids, sel_scores = pd.beam_search(pre_ids, top_ids, top_scores,
                                             BEAM, end_id=END, level=0)
        pd.increment(x=counter, value=1, in_place=True)
        pd.array_write(state, array=state_array, i=counter)
        pd.array_write(sel_ids, array=ids_array, i=counter)
        pd.array_write(sel_scores, array=scores_array, i=counter)
        pd.less_than(x=counter, y=array_len, cond=cond)
    ids, scores = pd.beam_search_decode(ids=ids_array, scores=scores_array)
    return dict(ids=ids, scores=scores, counter=counter,
                lens=fluid.default_main_program().global_block().var(
                    ids.lens_name))


def synthetic_wmt(rng, n):
    """Reverse-copy pairs (src, <s>+rev, rev+<e>) of 2-4 tokens (the JAX
    test's corpus)."""
    data = []
    for _ in range(n):
        src = rng.randint(3, DICT, size=rng.randint(2, 5))
        rev = src[::-1]
        data.append((src.tolist(), [START] + rev.tolist(),
                     rev.tolist() + [END]))
    return data


def lod_feed(seqs):
    lod = np.cumsum([0] + [len(s) for s in seqs]).astype(np.int32)
    flat = np.concatenate([np.asarray(s) for s in seqs]).reshape(-1, 1)
    return flat.astype(np.int64), [lod]


def train_feed(seed=0):
    data = synthetic_wmt(np.random.RandomState(seed), BATCH)
    return {"src_word_id": lod_feed([d[0] for d in data]),
            "target_language_word": lod_feed([d[1] for d in data]),
            "target_language_next_word": lod_feed([d[2] for d in data])}


def decode_feed(seed=1):
    data = synthetic_wmt(np.random.RandomState(seed), BATCH)
    lod = [list(range(BATCH + 1))] * 2
    return {"src_word_id": lod_feed([d[0] for d in data]),
            "init_ids": (np.full((BATCH, 1), START, np.int64), lod),
            "init_scores": (np.ones((BATCH, 1), np.float32), lod)}


def _decoder_params(pair):
    """The port's names of the parameters only the decoder uses: those
    the program creates after the encoder's."""
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        encoder(TF)
    n_enc = len(main.global_block().all_parameters())
    return [p.name for p in
            pair.tmain.global_block().all_parameters()[n_enc:]]


# Adagrad steps a parameter by lr*g/(sqrt(sum g^2)+eps), eps 1e-6: where
# |g| is near eps, an f32 rounding difference d in the gradient moves the
# parameter by up to lr*d/eps (2e5*d at the book's lr 0.2; after one
# step the worst element is 3.4e-5 off, then the book's large steps
# carry it on). So the book's Adagrad(0.2) is held on its losses, and the
# parameter bar on Adagrad(0.01) (worst 1.7e-6 after 3 steps) and
# SGD(0.2) (6e-8)
OPTIMIZERS = {"adagrad_book": ("Adagrad", 0.2),
              "adagrad_0.01": ("Adagrad", 0.01), "sgd": ("SGD", 0.2)}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_nmt_trains_alike(opt):
    pair = tp.FluidPair(lambda f, r: train_build(f, r, OPTIMIZERS[opt]))
    before = TF.scope_to_numpy(pair.tscope)
    jl, tl = train(pair, train_feed())
    if opt == "adagrad_book":
        np.testing.assert_allclose(tl, jl, rtol=1e-4)
    else:
        assert_trained_alike(pair, jl, tl)
    after = TF.scope_to_numpy(pair.tscope)
    dec = _decoder_params(pair)
    # fc([word, state]): two weights and a bias; fc(softmax): one and one
    assert len(dec) == 5
    for n in dec:
        assert np.abs(after[n] - before[n]).max() > 0, n


def _decode_alike(j, t):
    for k, (a, b) in enumerate(zip(j, t)):
        if k < 3:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


def test_nmt_decode_alike():
    pair = tp.FluidPair(decode_build)
    j, t = pair.run(decode_feed(), ["ids", "lens", "counter", "scores"])
    _decode_alike(j, t)
    assert t[0].shape == (BATCH * BEAM, MAX_LEN + 1)
    assert (t[0][:, 0] == START).all()
    assert ((t[1] >= 1) & (t[1] <= MAX_LEN + 1)).all()


@pytest.mark.parametrize("saver", ["torch", "jax"])
def test_decode_model_loads_in_the_other_package(saver, tmp_path):
    """save_inference_model of the decoder (a While sub-block and the
    beam ops) by one package, load_inference_model by the other: the
    same decode as the saver's own."""
    pair = tp.FluidPair(decode_build)
    feed = decode_feed(5)
    d = str(tmp_path / "decoder")
    feeds = ["src_word_id", "init_ids", "init_scores"]
    if saver == "torch":
        fluid, main, scope, exe = TF, pair.tmain, pair.tscope, pair.texe
        out = pair.tvars
        other, other_exe = JF, JF.Executor(JF.CPUPlace())
    else:
        fluid, main, scope, exe = JF, pair.jmain, pair.jscope, pair.jexe
        out = pair.jvars
        other, other_exe = TF, TF.Executor(TF.CPUPlace())
    with fluid.scope_guard(scope):
        want = exe.run(main, feed=feed, fetch_list=[out["ids"],
                                                    out["scores"]])
        fluid.io.save_inference_model(d, feeds, [out["ids"], out["scores"]],
                                      exe, main_program=main)
    with other.scope_guard(other.Scope()):
        prog, feed_names, fetches = other.io.load_inference_model(
            d, other_exe)
        got = other_exe.run(prog, feed=feed, fetch_list=fetches)
    assert feed_names == feeds
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-5, atol=1e-6)
