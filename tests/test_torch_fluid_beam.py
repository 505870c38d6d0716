"""Beam search in the port's Fluid against the JAX package's on the CPU:
one beam_search step, whole While-loop decodes (greedy, width 2 against
a numpy oracle), the early exit once every beam has ended (the same
fetched counter as the JAX package, the same sentences with the exit on
and off), the gate that disarms it when a later op reads loop state,
and num_results_per_sample. Each program is built by both packages'
fluid API from one set of JAX startup weights (`FluidPair`).

Bars: ids, lengths, parents and counters exact; scores within rtol
1e-5, atol 1e-6."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from paddle_tpu.fluid.core import kernels_control as jkc
from paddle_tpu_torch.fluid.core import kernels_control as tkc

torch.set_num_threads(2)

END = 0


def _exact(j, t, n_exact):
    """The first n_exact fetches equal, the rest (scores) close."""
    for k, (a, b) in enumerate(zip(j, t)):
        if k < n_exact:
            np.testing.assert_array_equal(b, a)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# --- one step ---------------------------------------------------------------

def test_beam_search_step_alike():
    def build(fluid, resnet):
        pd = fluid.layers
        pre_ids = pd.data(name="pre_ids", shape=[1], dtype="int64",
                          lod_level=2)
        ids = pd.data(name="ids", shape=[3], dtype="int64")
        scores = pd.data(name="scores", shape=[3], dtype="float32")
        sel_ids, sel_scores = pd.beam_search(pre_ids, ids, scores,
                                             beam_size=2, end_id=END)
        return dict(ids=sel_ids, scores=sel_scores)

    feed = {
        "pre_ids": (np.array([[1], [2]], np.int64), [[0, 1, 2], [0, 1, 2]]),
        "ids": np.array([[4, 2, 5], [3, 5, 2]], np.int64),
        # a tie in source 1: the lower candidate index wins
        "scores": np.array([[0.5, 0.3, 0.2], [0.9, 0.05, 0.05]],
                           np.float32),
    }
    pair = tp.FluidPair(build)
    j, t = pair.run(feed, ["ids", "scores"])
    _exact(j, t, 1)
    assert t[0].reshape(2, 2).tolist() == [[4, 2], [3, 5]]


# --- whole decodes ------------------------------------------------------------

def decoder(V, D, H, T, beam, k, prefix, state_read=False, n_res=0):
    """The JAX suite's While-loop decoder (tests/test_control_flow.py):
    arrays of states, ids and scores; sequence_expand over the beam
    parents; embedding + fc -> softmax -> topk -> beam_search."""
    def build(fluid, resnet):
        pd = fluid.layers
        init_state = pd.data(name="init_state", shape=[H], dtype="float32")
        init_ids = pd.data(name="init_ids", shape=[1], dtype="int64",
                           lod_level=2)
        init_scores = pd.data(name="init_scores", shape=[1],
                              dtype="float32", lod_level=2)
        array_len = pd.fill_constant(shape=[1], dtype="int64", value=T)
        counter = pd.zeros(shape=[1], dtype="int64", force_cpu=True)
        state_array = pd.create_array("float32")
        pd.array_write(init_state, array=state_array, i=counter)
        ids_array = pd.create_array("int64")
        scores_array = pd.create_array("float32")
        pd.array_write(init_ids, array=ids_array, i=counter)
        pd.array_write(init_scores, array=scores_array, i=counter)
        cond = pd.less_than(x=counter, y=array_len)
        w = pd.While(cond=cond)
        with w.block():
            pre_ids = pd.array_read(array=ids_array, i=counter)
            pre_state = pd.array_read(array=state_array, i=counter)
            pre_score = pd.array_read(array=scores_array, i=counter)
            expanded = pd.sequence_expand(pre_state, pre_score)
            emb = pd.embedding(input=pre_ids, size=[V, D], dtype="float32",
                               param_attr=fluid.ParamAttr(name=prefix + "emb"))
            state = pd.fc(input=[emb, expanded], size=H, act="tanh",
                          param_attr=fluid.ParamAttr(name=prefix + "dec"),
                          bias_attr=False)
            score = pd.fc(input=state, size=V, act="softmax",
                          param_attr=fluid.ParamAttr(name=prefix + "out"),
                          bias_attr=False)
            top_scores, top_ids = pd.topk(score, k=k)
            sel_ids, sel_scores = pd.beam_search(pre_ids, top_ids,
                                                 top_scores, beam,
                                                 end_id=END)
            pd.increment(x=counter, value=1, in_place=True)
            pd.array_write(state, array=state_array, i=counter)
            pd.array_write(sel_ids, array=ids_array, i=counter)
            pd.array_write(sel_scores, array=scores_array, i=counter)
            pd.less_than(x=counter, y=array_len, cond=cond)
        ids, scores = pd.beam_search_decode(
            ids=ids_array, scores=scores_array, beam_width=beam,
            num_results_per_sample=n_res)
        out = dict(ids=ids, scores=scores, counter=counter,
                   lens=fluid.default_main_program().global_block().var(
                       ids.lens_name))
        if state_read:  # a later op reads the state array
            out["state"] = pd.array_read(array=state_array, i=array_len)
        return out
    return build


def decode_feed(seed, B, H, scale=1.0):
    rng = np.random.RandomState(seed)
    lod = [list(range(B + 1))] * 2
    return {"init_state": (scale * rng.randn(B, H)).astype(np.float32),
            "init_ids": (np.full((B, 1), 1, np.int64), lod),
            "init_scores": (np.ones((B, 1), np.float32), lod)}


def _set_both(pair, name, value):
    pair.jscope.set(name, value)
    pair.tscope.set(name, value)


def _run_decode(pair, feed, extra=()):
    keys = ["ids", "lens", "counter", "scores"] + list(extra)
    j, t = pair.run(feed, keys)
    _exact(j, t, 3)
    return dict(zip(keys, t))


def test_greedy_decode_alike():
    """beam 1 == a numpy greedy rollout, token for token."""
    V, D, H, T, B = 7, 4, 5, 4, 2
    pair = tp.FluidPair(decoder(V, D, H, T, 1, 5, "g_"))
    feed = decode_feed(3, B, H)
    got = _run_decode(pair, feed)
    st = pair.jax_state()
    emb, dec_w, dec_u, out_w = (st[n] for n in (
        "g_emb", "g_dec", "g_dec_0", "g_out"))
    for b in range(B):
        state, tok, want = feed["init_state"][b], 1, [1]
        for _ in range(T):
            state = np.tanh(emb[tok] @ dec_w + state @ dec_u)
            tok = int(np.argmax(state @ out_w))
            want.append(tok)
            if tok == END:
                break
        assert got["ids"][b][:int(got["lens"][b])].tolist() == want


def _np_beam(init_states, emb, dec_w, dec_u, out_w, T, beam):
    """Numpy oracle of the full-width beam search (the JAX suite's)."""
    def softmax(z):
        e = np.exp(z - z.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    results = []
    for b in range(init_states.shape[0]):
        beams = [([1], init_states[b], 0.0, True)]
        for _ in range(T):
            cands = []
            for pi, (toks, st, fsc, alive) in enumerate(beams):
                if not alive:
                    cands.append((fsc, pi, END, st))
                    continue
                nst = np.tanh(emb[toks[-1]] @ dec_w + st @ dec_u)
                probs = softmax(nst @ out_w)
                for v in np.argsort(-probs)[:8]:
                    cands.append((float(probs[v]), pi, int(v), nst))
            cands.sort(key=lambda c: -c[0])
            nxt = []
            for sc, pi, v, nst in cands[:beam]:
                ptoks, _, _, palive = beams[pi]
                nxt.append((ptoks, nst, sc, False) if not palive else
                           (ptoks + [v], nst, sc, v != END))
            beams = nxt
        results.append({tuple(t) for t, _, _, _ in beams})
    return results


def test_width2_decode_alike_and_matches_numpy_oracle():
    V, D, H, T, BEAM, B = 9, 4, 5, 4, 2, 3
    pair = tp.FluidPair(decoder(V, D, H, T, BEAM, 8, "w_"))
    got = _run_decode(pair, decode_feed(7, B, H, scale=2.0))
    st = pair.jax_state()
    oracle = _np_beam(decode_feed(7, B, H, 2.0)["init_state"],
                      *(st[n] for n in ("w_emb", "w_dec", "w_dec_0",
                                        "w_out")), T, BEAM)
    ids = got["ids"].reshape(B, BEAM, -1)
    lens = got["lens"].reshape(B, BEAM)
    for b in range(B):
        assert {tuple(ids[b, k][:int(lens[b, k])].tolist())
                for k in range(BEAM)} == oracle[b]


def _early_pair(prefix, T, state_read=False):
    V, D, H = 7, 4, 5
    pair = tp.FluidPair(decoder(V, D, H, T, 2, 5, prefix, state_read))
    out_w = np.zeros((H, V), np.float32)
    out_w[:, END] = 4.0  # end_id dominates every softmax: beams die early
    _set_both(pair, prefix + "out", out_w)
    return pair, decode_feed(9, 2, H)


@pytest.fixture
def early_exit():
    """Set EARLY_EXIT_ENABLED in both packages; restore after."""
    old = (jkc.EARLY_EXIT_ENABLED, tkc.EARLY_EXIT_ENABLED)

    def set_(on):
        jkc.EARLY_EXIT_ENABLED = tkc.EARLY_EXIT_ENABLED = on
    yield set_
    jkc.EARLY_EXIT_ENABLED, tkc.EARLY_EXIT_ENABLED = old


def test_early_exit_counter_and_sentences_alike(early_exit, monkeypatch):
    """With the exit on the loop stops right after the beams die: the
    fetched counter is the JAX package's (far below the trip cap), the
    decode is the one the fixed-trip schedule gives, and the port read
    the device once per trip after the peel (plus the exit check)."""
    T_MAX = 24
    reads = []
    any_alive = tkc._any_alive
    monkeypatch.setattr(tkc, "_any_alive", lambda env, names: reads.append(
        1) or any_alive(env, names))
    runs = {}
    for on in (True, False):
        early_exit(on)
        pair, feed = _early_pair("ee_", T_MAX)
        runs[on] = _run_decode(pair, feed)
        runs[on]["stats"] = dict(tkc.LAST_WHILE_STATS)
        runs[on]["jax_stats"] = dict(jkc.LAST_WHILE_STATS)
    on, off = runs[True], runs[False]
    assert on["stats"]["early_exit_armed"] and on["jax_stats"][
        "early_exit_armed"]
    assert not off["stats"]["early_exit_armed"]
    assert on["stats"]["peeled"] == on["jax_stats"]["peeled"]
    steps = int(on["counter"][0])
    assert steps < T_MAX // 2 and int(off["counter"][0]) == T_MAX
    assert steps == on["stats"]["peeled"] + on["stats"]["executed"]
    assert len(reads) == on["stats"]["executed"] + 1
    for key in ("ids", "lens", "scores"):
        np.testing.assert_array_equal(on[key], off[key])


def test_early_exit_gate_disarms_on_state_read_alike(early_exit):
    """A later op reads the (non-beam) state array: the exit disarms and
    every trip runs, in both packages."""
    early_exit(True)
    T_MAX = 10
    pair, feed = _early_pair("gg_", T_MAX, state_read=True)
    got = _run_decode(pair, feed, extra=["state"])
    assert tkc.LAST_WHILE_STATS["early_exit_armed"] is False
    assert jkc.LAST_WHILE_STATS["early_exit_armed"] is False
    assert int(got["counter"][0]) == T_MAX
    assert np.isfinite(got["state"]).all()


def test_num_results_per_sample_alike():
    """Each source keeps its best n rows by final score, ties in row
    order (a stable argsort)."""
    V, D, H, T, BEAM, B = 9, 4, 5, 3, 3, 2
    pair = tp.FluidPair(decoder(V, D, H, T, BEAM, 6, "n_", n_res=2))
    got = _run_decode(pair, decode_feed(11, B, H, scale=2.0))
    assert got["ids"].shape == (B * 2, T + 1)
    assert (got["ids"][:, 0] == 1).all()
