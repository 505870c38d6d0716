"""Control flow in the port's Fluid against the JAX package's on the CPU:
tensor arrays and While, DynamicRNN (forward and training, dropout in
its body), IfElse, Switch, StaticRNN, the LoD tensor <-> array round
trip, 2-level LoD feeds and the top_k tie order. Each program is built
by both packages' fluid API (`FluidPair`), the JAX startup's weights are
carried into the port, and both run from a numpy seed's inputs.

Tolerances: f32 outputs within rtol 1e-5, atol 1e-6 (reduction order
only); training losses within rtol 1e-4 and parameters within atol 1e-5
after 3 steps (`assert_trained_alike`); ids, indices, lengths and
counters exact."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from torch_parity import JF, TF
from test_torch_fluid_lod_models import assert_trained_alike, train

torch.set_num_threads(2)


def _lod(lens):
    return np.cumsum([0] + list(lens)).astype(np.int32)


def _alike(j, t, rtol=1e-5, atol=1e-6):
    for a, b in zip(j, t):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


# --- tensor arrays and While ----------------------------------------------

def _while_build(limit=5):
    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[3], dtype="float32")
        lim = pd.fill_constant(shape=[1], dtype="int64", value=limit)
        counter = pd.zeros(shape=[1], dtype="int64", force_cpu=True)
        arr = pd.create_array("float32")
        pd.array_write(x, i=counter, array=arr)
        cond = pd.less_than(x=counter, y=lim)
        w = pd.While(cond=cond)
        with w.block():
            prev = pd.array_read(array=arr, i=counter)
            nxt = pd.elementwise_add(x=prev, y=pd.scale(x=x, scale=0.5))
            pd.increment(x=counter, value=1, in_place=True)
            pd.array_write(nxt, i=counter, array=arr)
            pd.less_than(x=counter, y=lim, cond=cond)
        final = pd.array_read(array=arr, i=lim)
        return dict(final=final, n=pd.array_length(arr), counter=counter)
    return build


def test_while_accumulates_over_tensor_arrays_alike():
    pair = tp.FluidPair(_while_build())
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    j, t = pair.run({"x": x}, ["final", "n", "counter"])
    _alike(j, t)
    np.testing.assert_allclose(t[0], x * 3.5, rtol=1e-6)
    assert int(t[1][0]) == 6 and int(t[2][0]) == 5


def test_loop_counters_stay_on_the_host():
    """The counter chain (the While condition, the limit, the array
    index) is kept on the host; the loop body's values are not."""
    from paddle_tpu_torch.fluid.core.kernels_control import host_names

    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        out = _while_build()(TF, None)
    names = host_names(main)
    assert out["counter"].name in names
    lim = [op.outputs["Out"][0] for op in main.global_block().ops
           if op.type == "fill_constant" and op.attrs["value"] == 5.0]
    assert lim and lim[0] in names
    assert out["final"].name not in names


# --- DynamicRNN -----------------------------------------------------------

D, H = 4, 5


def _rnn_build(dropout=None, train_it=False):
    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[D], dtype="float32", lod_level=1)
        rnn = pd.DynamicRNN()
        with rnn.block():
            w = rnn.step_input(x)
            pre = rnn.memory(shape=[H], value=0.0, dtype="float32")
            h = pd.fc(input=[w, pre], size=H, act="tanh",
                      param_attr=fluid.ParamAttr(name="cell_w"),
                      bias_attr=False)
            if dropout is not None:
                h = pd.dropout(h, dropout_prob=dropout)
            rnn.update_memory(pre, h)
            rnn.output(h)
        out = rnn()
        last = pd.sequence_last_step(input=out)
        res = dict(out=out, last=last)
        if train_it:
            label = pd.data(name="label", shape=[1], dtype="int64")
            logits = pd.fc(input=last, size=2, act="softmax")
            res["loss"] = pd.mean(x=pd.cross_entropy(input=logits,
                                                     label=label))
            fluid.optimizer.Adam(learning_rate=0.05).minimize(res["loss"])
        return res
    return build


def _rnn_feed(seed=0, lens=(3, 5, 1, 6)):
    rng = np.random.RandomState(seed)
    data = rng.randn(sum(lens), D).astype(np.float32)
    labels = rng.randint(0, 2, (len(lens), 1)).astype(np.int64)
    return {"x": (data, [_lod(lens)]), "label": labels}


def test_dynamic_rnn_forward_alike():
    pair = tp.FluidPair(_rnn_build())
    feed = _rnn_feed()
    j, t = pair.run({"x": feed["x"]}, ["out", "last"])
    _alike(j, t)
    assert t[0].shape == (15, H) and t[1].shape == (4, H)


@pytest.mark.parametrize("dropout", [None, 0.3])
def test_dynamic_rnn_trains_alike(dropout):
    """3 Adam steps through the per-step sub-block; with dropout in the
    body every step draws the keys the JAX package's one traced scan
    body draws."""
    pair = tp.FluidPair(_rnn_build(dropout, train_it=True))
    # a run's key folds in the executor's run count: the JAX executor
    # also ran the startup program
    pair.texe._run_counter = pair.jexe._run_counter
    jl, tl = train(pair, _rnn_feed(1))
    assert_trained_alike(pair, jl, tl)


# --- IfElse / Switch / StaticRNN ------------------------------------------

def test_ifelse_routes_rows_alike():
    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[2], dtype="float32")
        c = pd.data(name="c", shape=[1], dtype="bool")
        ie = pd.IfElse(c)
        with ie.true_block():
            d = ie.input(x)
            ie.output(pd.tanh(x=pd.scale(x=d, scale=3.0)))
        with ie.false_block():
            d = ie.input(x)
            ie.output(pd.scale(x=pd.exp(x=d), scale=2.0, bias=-1.0))
        (out,) = ie()
        return dict(out=out)

    rng = np.random.RandomState(2)
    x = rng.randn(7, 2).astype(np.float32)
    c = rng.rand(7, 1) > 0.5
    pair = tp.FluidPair(build)
    j, t = pair.run({"x": x, "c": c}, ["out"])
    _alike(j, t)
    np.testing.assert_allclose(
        t[0], np.where(c, np.tanh(3 * x), 2 * np.exp(x) - 1), rtol=1e-5)


def _switch_build(read_before_write):
    def build(fluid, resnet):
        pd = fluid.layers
        step = pd.data(name="s", shape=[1], dtype="float32")
        lr = pd.fill_constant(shape=[1], dtype="float32", value=0.8)
        aux = pd.fill_constant(shape=[1], dtype="float32", value=7.0)
        one = pd.fill_constant(shape=[1], dtype="float32", value=1.0)
        two = pd.fill_constant(shape=[1], dtype="float32", value=2.0)
        with pd.Switch() as sw:
            with sw.case(pd.less_than(step, one)):
                if read_before_write:
                    pd.assign(pd.scale(x=lr, scale=0.5), lr)
                else:
                    pd.assign(pd.fill_constant(shape=[1], dtype="float32",
                                               value=0.1), lr)
            with sw.case(pd.less_than(step, two)):
                pd.assign(pd.fill_constant(shape=[1], dtype="float32",
                                           value=0.3), lr)
                pd.assign(pd.fill_constant(shape=[1], dtype="float32",
                                           value=9.0), aux)
            if not read_before_write:
                with sw.default():
                    pd.assign(pd.fill_constant(shape=[1], dtype="float32",
                                               value=1.0), lr)
        return dict(lr=pd.scale(x=lr, scale=1.0),
                    aux=pd.scale(x=aux, scale=1.0))
    return build


@pytest.mark.parametrize("read_before_write", [False, True])
def test_switch_first_true_case_wins_alike(read_before_write):
    pair = tp.FluidPair(_switch_build(read_before_write))
    want = {False: {0.5: (0.1, 7.0), 1.5: (0.3, 9.0), 5.0: (1.0, 7.0)},
            True: {0.5: (0.4, 7.0), 1.5: (0.3, 9.0), 5.0: (0.8, 7.0)}}
    for s, (lr, aux) in want[read_before_write].items():
        j, t = pair.run({"s": np.array([[s]], np.float32)}, ["lr", "aux"])
        _alike(j, t)
        np.testing.assert_allclose([t[0][0], t[1][0]], [lr, aux],
                                   rtol=1e-6)


@pytest.mark.parametrize("fluid", [JF, TF], ids=["jax", "torch"])
def test_switch_case_after_default_raises(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        pd = fluid.layers
        lr = pd.fill_constant(shape=[1], dtype="float32", value=0.0)
        one = pd.fill_constant(shape=[1], dtype="float32", value=1.0)
        with pytest.raises(ValueError, match="no case after default"):
            with pd.Switch() as sw:
                with sw.default():
                    pd.assign(one, lr)
                with sw.case(pd.less_than(lr, one)):
                    pd.assign(one, lr)


def test_static_rnn_matches_manual_unroll_alike():
    T, N = 3, 2

    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[T, N, D], dtype="float32",
                    append_batch_size=False)
        h0 = pd.fill_constant(shape=[N, D], dtype="float32", value=0.0)
        rnn = pd.StaticRNN()
        with rnn.step():
            xt = rnn.step_input(x)
            hprev = rnn.memory(init=h0)
            w = pd.create_parameter([D, D], "float32", attr="srnn_w")
            h = pd.tanh(x=pd.elementwise_add(x=pd.matmul(x=xt, y=w),
                                             y=pd.matmul(x=hprev, y=w)))
            rnn.update_memory(hprev, h)
            rnn.step_output(h)
        return dict(out=rnn(), w=fluid.default_main_program()
                    .global_block().var("srnn_w"))

    x = np.random.RandomState(3).randn(T, N, D).astype(np.float32)
    pair = tp.FluidPair(build)
    j, t = pair.run({"x": x}, ["out", "w"])
    _alike(j, t)
    h, want = np.zeros((N, D), np.float32), []
    for s in range(T):
        h = np.tanh(x[s] @ t[1] + h @ t[1])
        want.append(h)
    np.testing.assert_allclose(t[0], np.stack(want), rtol=1e-5, atol=1e-6)


# --- LoD tensor <-> tensor array ------------------------------------------

def test_lod_tensor_array_round_trip_alike():
    """The rank table, the reorder, the array round trip and
    shrink_memory. The port's array holds exactly the longest sequence's
    steps where the JAX package pads to its bucket (8): the packed rows
    and the LoD agree, the JAX output has more zero rows behind them."""
    lens = [2, 4, 1]

    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[2], dtype="float32", lod_level=1)
        table = pd.lod_rank_table(x)
        arr = pd.lod_tensor_to_array(x, table)
        i = pd.fill_constant(shape=[1], dtype="int64", value=1)
        step = pd.array_read(arr, i)
        return dict(table=table, mx=pd.max_sequence_len(table),
                    ro=pd.reorder_lod_tensor_by_rank(x, table),
                    back=pd.array_to_lod_tensor(arr, table), step=step,
                    shrunk=pd.shrink_memory(step, i, table))

    x = np.random.RandomState(4).randn(7, 2).astype(np.float32)
    pair = tp.FluidPair(build)
    keys = ["table", "mx", "ro", "back", "step", "shrunk"]
    j, t = pair.run({"x": (x, [_lod(lens)])}, keys)
    for k, a, b in zip(keys, j, t):
        if k == "back":
            np.testing.assert_array_equal(b[:7], a[:7])
            np.testing.assert_array_equal(b[:7], x)
            assert not a[7:].any() and not b[7:].any()
        else:
            np.testing.assert_array_equal(b, a, err_msg=k)


# --- 2-level LoD feeds ------------------------------------------------------

class _LoDTensor(object):
    def __init__(self, data, lod):
        self.data, self._lod = data, lod

    def lod(self):
        return self._lod


def _beam_step_build(fluid, resnet):
    pd = fluid.layers
    pre_ids = pd.data(name="pre_ids", shape=[1], dtype="int64", lod_level=2)
    ids = pd.data(name="ids", shape=[2], dtype="int64")
    scores = pd.data(name="scores", shape=[2], dtype="float32")
    sel_ids, sel_scores = pd.beam_search(pre_ids, ids, scores, beam_size=2,
                                         end_id=0, level=0)
    return dict(ids=sel_ids, scores=sel_scores)


_TWO_LEVEL = dict(
    pre_ids=np.array([[1], [2], [3], [4]], np.int64),
    lod=[[0, 2, 4], [0, 1, 2, 3, 4]],
    ids=np.array([[4, 2], [5, 6], [7, 8], [9, 3]], np.int64),
    scores=np.array([[0.1, 0.2], [0.6, 0.5], [0.3, 0.25], [0.9, 0.1]],
                    np.float32))


@pytest.mark.parametrize("as_object", [False, True])
def test_two_level_feed_alike(as_object):
    """The finest level describes the rows, the outer one the sources:
    top-k runs per source over all its prefixes."""
    f = _TWO_LEVEL
    pre = _LoDTensor(f["pre_ids"], f["lod"]) if as_object \
        else (f["pre_ids"], f["lod"])
    pair = tp.FluidPair(_beam_step_build)
    feed = {"pre_ids": (f["pre_ids"], f["lod"]), "ids": f["ids"],
            "scores": f["scores"]}
    j, _ = pair.run(feed, ["ids", "scores"])
    _, t = pair.run(dict(feed, pre_ids=pre), ["ids", "scores"])
    _alike(j, t)
    assert t[0].reshape(2, 2).tolist() == [[5, 6], [9, 7]]


def test_non_uniform_two_level_feed_raises():
    """Full-width beams need the same number of prefixes per source. The
    JAX package fails on a count that does not divide (its reshape);
    the port checks the host copy of the outer level and fails on any
    non-uniform one."""
    f = _TWO_LEVEL
    for lod, sides in (([[0, 1, 3], [0, 1, 2, 3]], (JF, TF)),
                       ([[0, 1, 4], [0, 1, 2, 3, 4]], (TF,))):
        n = lod[1][-1]
        feed = {"pre_ids": (f["pre_ids"][:n], lod), "ids": f["ids"][:n],
                "scores": f["scores"][:n]}
        for fluid in sides:
            main, startup = fluid.Program(), fluid.Program()
            with fluid.program_guard(main, startup):
                out = _beam_step_build(fluid, None)
            exe = fluid.Executor(fluid.CPUPlace())
            with pytest.raises(Exception):
                exe.run(main, feed=feed, fetch_list=[out["ids"]])


# --- top_k tie order ----------------------------------------------------------

def test_top_k_breaks_ties_lowest_index_first_alike():
    """`lax.top_k` returns tied values lowest index first; so does the
    port's top_k on every device (torch.topk orders ties by its own
    algorithm)."""
    x = np.zeros((3, 40), np.float32)
    x[0, 20] = 1.0
    x[1, ::3] = 0.5
    x[2] = np.random.RandomState(5).randint(0, 3, 40)

    def build(fluid, resnet):
        v = fluid.layers.data(name="x", shape=[40], dtype="float32")
        vals, idx = fluid.layers.topk(v, k=10)
        return dict(vals=vals, idx=idx)

    pair = tp.FluidPair(build)
    j, t = pair.run({"x": x}, ["vals", "idx"])
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[0], j[0])
    assert t[1][0].tolist() == [20, 0, 1, 2, 3, 4, 5, 6, 7, 8]


# --- Print, get_places, ParallelDo ------------------------------------------

def test_print_keeps_its_first_n_budget(capsys):
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        x = TF.layers.data(name="x", shape=[3], dtype="float32")
        y = TF.layers.Print(x, first_n=2, message="seen",
                            print_phase="forward")
        out = TF.layers.scale(x=y, scale=2.0)
    exe = TF.Executor(TF.CPUPlace())
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    for _ in range(3):
        got = exe.run(main, feed={"x": xv}, fetch_list=[out])[0]
    np.testing.assert_array_equal(got, 2 * xv)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("seen")]
    assert len(lines) == 2 and "shape=(2, 3)" in lines[0]


def test_parallel_do_inlines_on_one_device_alike():
    def build(fluid, resnet):
        pd = fluid.layers
        x = pd.data(name="x", shape=[4], dtype="float32")
        places = pd.get_places()
        par = pd.ParallelDo(places)
        with par.do():
            xi = par.read_input(x)
            par.write_output(pd.fc(input=xi, size=3, act="relu"))
        return dict(out=pd.mean(x=par()))

    assert TF.layers.get_places() == (
        [TF.CUDAPlace(i) for i in range(torch.cuda.device_count())]
        or [TF.CPUPlace()])
    pair = tp.FluidPair(build)
    x = np.random.RandomState(6).randn(5, 4).astype(np.float32)
    j, t = pair.run({"x": x}, ["out"])
    _alike(j, t)
