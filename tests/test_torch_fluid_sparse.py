"""The port's SelectedRows sparse-gradient path against the JAX package's
on the CPU (tests/test_selected_rows.py, case for case): the same
programs, built by each package's fluid API, train from the same JAX
startup tables (tests/torch_parity.py `FluidPair`).

Left out: the row-sharded SPMD case (the mesh executor is not ported).
memory_optimize: the port has no `fluid.memory_optimize`; it carries the
IR's `remat` flag that the JAX transpiler sets (serialization keeps it)
and runs such a program without rematerialising, so its case checks
that a remat-flagged sparse program still trains dense-equal, against
the JAX package's rematerialised run.

Tolerances: within each package, sparse SGD equals dense within 1e-6
(duplicate rows are added one by one instead of summed first), as the
JAX tests hold; port vs JAX tables and optimizer state within 1e-6
(SGD, Momentum, Adagrad) and 5e-6 (Adam, whose first step divides by
sqrt of a tiny second moment); lazy Adam's untouched rows and moments
bit for bit; bf16 AMP runs within 5e-3 of the dense AMP run (the JAX
test's bar) and of each other's package; merged() rows identical and
values within 1e-6."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parity as tp
from paddle_tpu.fluid.core.selected_rows import SelectedRows as JSR
from paddle_tpu_torch.fluid.core import lowering
from paddle_tpu_torch.fluid.core.selected_rows import SelectedRows
from torch_parity import TF

torch.set_num_threads(2)

OPTS = {
    "sgd": lambda f: f.optimizer.SGD(learning_rate=0.2),
    "momentum": lambda f: f.optimizer.Momentum(learning_rate=0.1,
                                               momentum=0.9),
    "adagrad": lambda f: f.optimizer.Adagrad(learning_rate=0.3),
    "adam": lambda f: f.optimizer.Adam(learning_rate=0.05),
}
TOL = {"sgd": 1e-6, "momentum": 1e-6, "adagrad": 1e-6, "adam": 5e-6}


def embedding_model(vocab, dim, is_sparse, opt, padding_idx=None,
                    regularizer=None, seed=7):
    """tests/test_selected_rows.py's model: ids -> embedding -> fc(1) ->
    mse against a fed target."""
    def build(fluid, resnet):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(
            input=ids, size=[vocab, dim], is_sparse=is_sparse,
            padding_idx=padding_idx, param_attr=fluid.ParamAttr(
                name="emb_w", regularizer=regularizer,
                initializer=fluid.initializer.Normal(scale=0.2, seed=seed)))
        pred = fluid.layers.fc(
            input=emb, size=1, act=None, param_attr=fluid.ParamAttr(
                name="fc_w", initializer=fluid.initializer.Constant(0.5)))
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        opt(fluid).minimize(loss)
        grad = fluid.default_main_program().global_block().var("emb_w@GRAD")
        return dict(loss=loss, grad=grad)
    return build


def batches(n_steps, vocab, batch=8, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_steps):
        ids = rng.randint(0, vocab, size=(batch, 1)).astype(np.int64)
        ids[1] = ids[0]  # a duplicate row in every batch
        y = rng.uniform(-1, 1, size=(batch, 1)).astype(np.float32)
        out.append(dict(ids=ids, y=y))
    return out


def train(build, feeds, fetch=("loss",), amp=False, remat=False):
    """A FluidPair trained over `feeds`: (pair, [(jax, port) fetches])."""
    pair = tp.FluidPair(build, amp=amp)
    if remat:
        from paddle_tpu.fluid import memory_optimize

        memory_optimize(pair.jmain)
        pair.tmain.remat = True
    outs = [pair.run(f, list(fetch)) for f in feeds]
    return pair, outs


def tables(pair, name="emb_w"):
    """(JAX table, port table) as numpy."""
    return (np.asarray(pair.jscope.get(name)),
            TF.scope_to_numpy(pair.tscope)[pair.names[name]])


def table_state(pair, vocab, dim):
    """The port's [vocab, dim] persistables (the table and its optimizer
    state) in the program's order."""
    state = TF.scope_to_numpy(pair.tscope)
    return [state[v.name] for v in pair.tmain.global_block().vars.values()
            if v.name in state and state[v.name].shape == (vocab, dim)]


def assert_state_close(pair, atol):
    diff = pair.state_diff()
    bad = {n: d for n, d in diff.items() if d > atol}
    assert not bad, bad


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_sparse_trains_like_jax(opt):
    """Five steps with duplicate ids: the port's sparse step equals the
    JAX package's (tables and optimizer state) for every optimizer with
    a sparse branch."""
    pair, outs = train(embedding_model(50, 6, True, OPTS[opt]),
                       batches(5, 50))
    for j, t in outs:
        np.testing.assert_allclose(t[0], j[0], rtol=1e-5, atol=1e-7)
    assert_state_close(pair, TOL[opt])


def test_sgd_sparse_matches_dense_exactly():
    bs = batches(5, 50)
    dense, _ = train(embedding_model(50, 6, False, OPTS["sgd"]), bs)
    sparse, _ = train(embedding_model(50, 6, True, OPTS["sgd"]), bs)
    (jd, td), (js, ts) = tables(dense), tables(sparse)
    np.testing.assert_allclose(ts, td, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    np.testing.assert_allclose(js, jd, rtol=0, atol=1e-6)


def test_sgd_sparse_with_padding_idx():
    vocab, dim, pad = 40, 4, 3
    bs = batches(4, vocab)
    for f in bs:
        f["ids"][2] = pad
    sgd = lambda f: f.optimizer.SGD(learning_rate=0.1)
    dense, _ = train(embedding_model(vocab, dim, False, sgd,
                                     padding_idx=pad), bs)
    sparse, _ = train(embedding_model(vocab, dim, True, sgd,
                                      padding_idx=pad), bs)
    w0 = tp.FluidPair(embedding_model(vocab, dim, True, sgd,
                                      padding_idx=pad)).jax_state()["emb_w"]
    (jd, td), (js, ts) = tables(dense), tables(sparse)
    np.testing.assert_allclose(ts, td, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    # the padding row never moves off its init
    np.testing.assert_array_equal(ts[pad], w0[pad])
    np.testing.assert_array_equal(js[pad], w0[pad])


@pytest.mark.parametrize("opt", ["adagrad", "adam"])
def test_sparse_single_step_matches_dense(opt):
    bs = batches(1, 30)
    dense, _ = train(embedding_model(30, 5, False, OPTS[opt]), bs)
    sparse, _ = train(embedding_model(30, 5, True, OPTS[opt]), bs)
    (jd, td), (js, ts) = tables(dense), tables(sparse)
    np.testing.assert_allclose(ts, td, rtol=0, atol=TOL[opt])
    np.testing.assert_allclose(ts, js, rtol=0, atol=TOL[opt])


@pytest.mark.parametrize("opt", ["momentum", "adagrad", "adam"])
def test_lazy_update_keeps_untouched_rows_bit_exact(opt):
    """Reference SparseAdamFunctor semantics, in both packages: rows
    absent from a batch keep their parameter AND optimizer state bit
    for bit (row 5 is touched in step 1 only); dense momentum and adam
    keep moving row 5 on its nonzero velocity or moments."""
    vocab, dim = 20, 4
    y = np.random.RandomState(1).uniform(-1, 1, (4, 1)).astype(np.float32)
    first = np.array([[1], [2], [3], [5]], np.int64)
    later = np.array([[1], [2], [3], [1]], np.int64)
    one = [dict(ids=first, y=y)]
    three = one + [dict(ids=later, y=y)] * 2
    after_one, _ = train(embedding_model(vocab, dim, True, OPTS[opt]), one)
    sparse, _ = train(embedding_model(vocab, dim, True, OPTS[opt]), three)
    dense, _ = train(embedding_model(vocab, dim, False, OPTS[opt]), three)
    w0 = tp.FluidPair(embedding_model(vocab, dim, True, OPTS[opt])
                      ).jax_state()["emb_w"]
    s1, s3 = table_state(after_one, vocab, dim), table_state(sparse, vocab,
                                                            dim)
    assert len(s3) == {"momentum": 2, "adagrad": 2, "adam": 3}[opt]
    never = [r for r in range(vocab) if r not in (1, 2, 3, 5)]
    for a, b in zip(s1, s3):
        # row 5 froze after step 1, the never-touched rows at init
        np.testing.assert_array_equal(b[5], a[5])
        np.testing.assert_array_equal(b[never], a[never])
    _, ts = tables(sparse)
    np.testing.assert_array_equal(ts[never], w0[never])
    _, td = tables(dense)
    if opt == "adagrad":
        # a zero gradient moves nothing under adagrad: lazy == dense
        np.testing.assert_array_equal(td[5], ts[5])
    else:
        assert np.abs(td[5] - ts[5]).max() > 1e-5
    assert np.abs(ts[[1, 2, 3]] - w0[[1, 2, 3]]).max() > 1e-4
    assert_state_close(sparse, TOL[opt])


def test_two_sparse_sites_share_one_table():
    """Two lookups into one table with a cross-site duplicate: the site
    gradients concatenate into one SelectedRows; sparse equals dense."""
    def model(is_sparse):
        def build(fluid, resnet):
            a = fluid.layers.data(name="a", shape=[1], dtype="int64")
            b = fluid.layers.data(name="b", shape=[1], dtype="int64")
            y = fluid.layers.data(name="y", shape=[1], dtype="float32")
            attr = fluid.ParamAttr(
                name="emb_w",
                initializer=fluid.initializer.Normal(scale=0.2, seed=3))
            ea = fluid.layers.embedding(input=a, size=[25, 4],
                                        is_sparse=is_sparse, param_attr=attr)
            eb = fluid.layers.embedding(input=b, size=[25, 4],
                                        is_sparse=is_sparse, param_attr=attr)
            pred = fluid.layers.fc(
                input=fluid.layers.elementwise_add(x=ea, y=eb), size=1,
                param_attr=fluid.ParamAttr(
                    name="fc_w",
                    initializer=fluid.initializer.Constant(0.3)))
            loss = fluid.layers.mean(
                x=fluid.layers.square_error_cost(input=pred, label=y))
            fluid.optimizer.SGD(learning_rate=0.2).minimize(loss)
            return dict(loss=loss)
        return build

    rng = np.random.RandomState(5)
    a = rng.randint(0, 25, size=(6, 1)).astype(np.int64)
    b = rng.randint(0, 25, size=(6, 1)).astype(np.int64)
    b[0] = a[0]
    feed = dict(a=a, b=b, y=rng.uniform(-1, 1, (6, 1)).astype(np.float32))
    dense, _ = train(model(False), [feed] * 3)
    sparse, _ = train(model(True), [feed] * 3)
    (jd, td), (js, ts) = tables(dense), tables(sparse)
    np.testing.assert_allclose(ts, td, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


def test_regularizer_falls_back_to_dense():
    """A weight-decay regularizer's op reads the gradient, so the table
    takes the exact dense path: equal to the is_sparse=False run."""
    bs = batches(3, 20)
    reg = lambda f: f.regularizer.L2Decay(0.01)

    def model(is_sparse):
        def build(fluid, resnet):
            return embedding_model(20, 4, is_sparse, OPTS["sgd"],
                                   regularizer=reg(fluid))(fluid, resnet)
        return build

    dense, _ = train(model(False), bs)
    sparse, _ = train(model(True), bs)
    (jd, td), (js, ts) = tables(dense), tables(sparse)
    np.testing.assert_array_equal(ts, td)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)


def test_fetched_sparse_grad_densifies():
    bs = batches(1, 15)
    sgd = lambda f: f.optimizer.SGD(learning_rate=0.1)
    _, dense = train(embedding_model(15, 3, False, sgd), bs,
                     fetch=("loss", "grad"))
    _, sparse = train(embedding_model(15, 3, True, sgd), bs,
                      fetch=("loss", "grad"))
    (jd, td), (js, ts) = dense[0], sparse[0]
    assert ts[1].shape == (15, 3)
    np.testing.assert_allclose(ts[1], td[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts[1], js[1], rtol=0, atol=1e-6)


def _grad_of(build, feed, name="emb_w@GRAD"):
    """The value the port's lowering binds to `name` in one training run
    (the executor fetches it densified; the optimizer sees this)."""
    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        build(TF, None)
    scope = TF.Scope()
    seen = {}
    run_ops = lowering.run_ops

    def spy(ctx, ops, env):
        if name in env:
            seen["grad"] = env[name]
        return run_ops(ctx, ops, env)

    with TF.scope_guard(scope):
        exe = TF.Executor(TF.CPUPlace())
        exe.run(startup)
        lowering.run_ops = spy
        try:
            exe.run(main, feed=feed)
        finally:
            lowering.run_ops = run_ops
    return seen["grad"]


@pytest.mark.parametrize("case", ["sgd", "momentum", "adagrad", "adam",
                                  "adamax", "regularizer", "clip",
                                  "dense_reader"])
def test_which_tables_take_the_sparse_path(case):
    """A qualifying table's gradient is a SelectedRows of the touched
    rows; a regularizer, a gradient clip, a dense reader of the table or
    an optimizer without a sparse branch (adamax) gives the dense
    gradient, as the JAX package decides (lowering._find_sparse_sites)."""
    def build(fluid, resnet):
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        reg = fluid.regularizer.L2Decay(0.01) if case == "regularizer" \
            else None
        clip = fluid.clip.GradientClipByValue(0.1) if case == "clip" \
            else None
        emb = fluid.layers.embedding(
            input=ids, size=[12, 3], is_sparse=True,
            param_attr=fluid.ParamAttr(name="emb_w", regularizer=reg,
                                       gradient_clip=clip))
        pred = fluid.layers.fc(input=emb, size=1)
        loss = fluid.layers.mean(
            x=fluid.layers.square_error_cost(input=pred, label=y))
        if case == "dense_reader":
            w = fluid.default_main_program().global_block().var("emb_w")
            loss = fluid.layers.elementwise_add(
                x=loss, y=fluid.layers.reduce_sum(w))
        opt = fluid.optimizer.Adamax(learning_rate=0.1) \
            if case == "adamax" else OPTS.get(case, OPTS["sgd"])(fluid)
        opt.minimize(loss)

    feed = batches(1, 12)[0]
    g = _grad_of(build, feed)
    if case in OPTS:
        assert isinstance(g, SelectedRows)
        assert g.values.shape == (8, 3) and g.height == 12
        np.testing.assert_array_equal(g.rows.numpy(), feed["ids"][:, 0])
    else:
        assert isinstance(g, torch.Tensor) and g.shape == (12, 3)


def test_merged_combines_duplicates_and_drops_sentinels():
    rows = np.array([7, 2, 7, 9, 2, 11], np.int64)  # 11 == height
    vals = np.arange(12, dtype=np.float32).reshape(6, 2)
    sr = SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals), 11)
    r, v = sr.merged()
    got = {int(ri): v[i].numpy() for i, ri in enumerate(r) if ri < 11}
    assert set(got) == {2, 7, 9}
    np.testing.assert_array_equal(got[7], vals[0] + vals[2])
    np.testing.assert_array_equal(got[2], vals[1] + vals[4])
    np.testing.assert_array_equal(got[9], vals[3])
    np.testing.assert_array_equal(
        sr.to_dense().numpy()[[2, 7, 9]],
        np.stack([got[2], got[7], got[9]]))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_merged_matches_jax(seed):
    """merged() against the JAX package's on random rows with duplicates
    and sentinels: rows identical (ascending, sentinels last), values
    within 1e-6; to_dense() likewise."""
    rng = np.random.RandomState(seed)
    height, n, dim = 13, 40, 5
    rows = rng.randint(0, height + 1, n)  # height: a sentinel
    rows[:5] = rows[5]
    vals = rng.randn(n, dim).astype(np.float32)
    jr, jv = jax.jit(lambda: JSR(jnp.asarray(rows, jnp.int32),
                                 jnp.asarray(vals), height).merged())()
    sr = SelectedRows(torch.from_numpy(rows.astype(np.int64)),
                      torch.from_numpy(vals), height)
    tr, tv = sr.merged()
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # a sentinel slot's value is not read by any consumer
    keep = np.asarray(jr) < height
    np.testing.assert_allclose(tv.numpy()[keep], np.asarray(jv)[keep],
                               rtol=0, atol=1e-6)
    jd = JSR(jnp.asarray(rows, jnp.int32), jnp.asarray(vals),
             height).to_dense()
    np.testing.assert_allclose(sr.to_dense().numpy(), np.asarray(jd),
                               rtol=0, atol=1e-6)


def _count_vocab_sized(is_sparse, vocab=1_000_000, dim=8, batch=16):
    """Op outputs with a leading dimension of `vocab` in one steady SGD
    step of the port (a second run, after the first moved the scope
    to the device), counted under a TorchDispatchMode."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (list, tuple)) else [out]):
                if isinstance(t, torch.Tensor) and t.dim() and \
                        t.shape[0] == vocab:
                    Count.n += 1
            return out

    main, startup = TF.Program(), TF.Program()
    with TF.program_guard(main, startup):
        loss = embedding_model(vocab, dim, is_sparse,
                               OPTS["sgd"])(TF, None)["loss"]
    scope = TF.Scope()
    block = main.global_block()
    TF.scope_from_numpy(scope, {
        v.name: np.zeros([max(d, 1) for d in v.shape], np.float32)
        for v in block.vars.values() if v.persistable}, "cpu")
    feed = dict(ids=np.zeros((batch, 1), np.int64),
                y=np.zeros((batch, 1), np.float32))
    with TF.scope_guard(scope):
        exe = TF.Executor(TF.CPUPlace())
        exe.run(main, feed=feed, fetch_list=[loss])
        with Count():
            exe.run(main, feed=feed, fetch_list=[loss])
    return Count.n


def test_sparse_step_work_scales_with_rows_not_vocab():
    """No [vocab, dim] gradient exists in the sparse step: at a 1M-row
    vocab its only vocab-sized op outputs are the table's in-place row
    update and the scope's detached handle (at most 2), while the dense
    step builds vocab-sized gradients (strictly more)."""
    n_sparse = _count_vocab_sized(True)
    n_dense = _count_vocab_sized(False)
    assert n_sparse <= 2, n_sparse
    assert n_sparse < n_dense, (n_sparse, n_dense)


def test_sparse_composes_with_amp():
    """program.amp (bf16 forward region) + is_sparse: the site leaves are
    bf16, the SelectedRows values come back f32 for the optimizer; the
    table stays f32 and close to the dense AMP run and to the JAX
    package's sparse AMP run."""
    bs = batches(3, 40)
    sgd = lambda f: f.optimizer.SGD(learning_rate=0.1)
    sparse, outs = train(embedding_model(40, 8, True, sgd), bs, amp=True)
    dense, _ = train(embedding_model(40, 8, False, sgd), bs, amp=True)
    for j, t in outs:
        assert np.isfinite(t[0]).all()
    (js, ts), (_, td) = tables(sparse), tables(dense)
    assert ts.dtype == np.float32
    np.testing.assert_allclose(ts, td, rtol=0, atol=5e-3)
    np.testing.assert_allclose(ts, js, rtol=0, atol=5e-3)


def test_sparse_composes_with_memory_optimize():
    """A remat-flagged program (what the JAX package's memory_optimize
    sets) trains sparse == dense in the port, and equal to the JAX
    package's rematerialised sparse run."""
    bs = batches(3, 30)
    sgd = lambda f: f.optimizer.SGD(learning_rate=0.2)
    sparse, _ = train(embedding_model(30, 5, True, sgd), bs, remat=True)
    dense, _ = train(embedding_model(30, 5, False, sgd), bs, remat=True)
    (js, ts), (_, td) = tables(sparse), tables(dense)
    np.testing.assert_allclose(ts, td, rtol=0, atol=1e-6)
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
