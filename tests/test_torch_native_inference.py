"""The port's native inference runner (paddle_tpu_torch.native.InferenceRunner
over inference.cc) and merge_v2_model (paddle_tpu_torch.utils.merge_model)
against the port's CPU Executor and the JAX package's runner.

- Bundles the port's `save_inference_model` writes (an MLP, a conv net
  with batch norm, DeepFM, the LSTM sentiment net over LoD ids, the CRNN
  OCR with its ragged CTC decode, a KV-cache greedy decoder) give the
  Executor's outputs through the runner: within 1e-4 (the JAX tests'
  tolerance; f32, another summation order), decoded tokens and output
  offsets exactly.
- Bundles the JAX package saves give the JAX runner's outputs through
  the port's runner, bit for bit (the same C++ source and g++ flags).
- The library serves from a bare interpreter (dlopen + ctypes, no port
  import), and four processes that build it at once on an empty
  `_build/` all load it.
- merge_v2_model turns a v2 tar written by either package into a bundle
  that serves the outputs of `paddle.infer` (1e-4) and of the JAX
  package's merge (bit for bit); a tar that misses a parameter raises
  ValueError as the JAX package's does.
"""

import io
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as JF
import paddle_tpu.native as jnative
import paddle_tpu_torch.fluid as TF
import paddle_tpu_torch.native as tnative
from torch_native_build import ensure_jax_infer, ensure_port_infer

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _runners_built():
    ensure_port_infer()
    ensure_jax_infer()


def _models(fluid):
    return "paddle_tpu_torch.models" if fluid is TF else "paddle_tpu.models"


def _import(fluid, name):
    import importlib

    return importlib.import_module(_models(fluid) + "." + name)


# --- the models: build(fluid) -> (feed names, fetch vars, feeds, lods) --


def mlp(fluid):
    L = fluid.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    h = L.fc(input=x, size=16, act="relu")
    y = L.fc(input=h, size=4, act="softmax")
    xv = np.random.RandomState(1).randn(5, 8).astype(np.float32)
    return ["x"], [y], {"x": xv}, {}


def conv(fluid):
    L = fluid.layers
    img = L.data(name="img", shape=[1, 12, 12], dtype="float32")
    c = L.conv2d(input=img, num_filters=4, filter_size=3, act="relu")
    p = L.pool2d(input=c, pool_size=2, pool_stride=2)
    bn = L.batch_norm(input=p)
    y = L.fc(input=bn, size=3, act="softmax")
    xv = np.random.RandomState(2).randn(2, 1, 12, 12).astype(np.float32)
    return ["img"], [y], {"img": xv}, {}


def deepfm(fluid):
    L = fluid.layers
    ids = L.data(name="ids", shape=[6], dtype="int64")
    y = L.data(name="y", shape=[1], dtype="float32")
    _, prob = _import(fluid, "ctr").deepfm(ids, y, num_fields=6, vocab=48,
                                           embed_dim=8, deep_dims=(16,))
    iv = np.random.RandomState(3).randint(0, 48, (7, 6)).astype(np.int64)
    return ["ids"], [prob], {"ids": iv}, {}


def padding_idx(fluid):
    L = fluid.layers
    ids = L.data(name="pids", shape=[4], dtype="int64")
    emb = L.embedding(input=ids, size=[12, 5], padding_idx=0)
    out = L.reduce_sum(emb, dim=1)
    iv = np.array([[0, 3, 0, 7], [1, 0, 2, 0]], np.int64)
    return ["pids"], [out], {"pids": iv}, {}


def lstm_sentiment(fluid):
    """embedding over LoD ids -> fc(4H) -> dynamic_lstm -> last step and
    average pool -> softmax head (tests/test_native_serving_seq.py)."""
    L = fluid.layers
    vocab, hid = 30, 6

    def attr(name, seed):
        return fluid.ParamAttr(name=name, initializer=fluid.initializer
                               .Normal(scale=0.3, seed=seed))

    words = L.data(name="words", shape=[1], dtype="int64", lod_level=1)
    emb = L.embedding(input=words, size=[vocab, 8],
                      param_attr=attr("s_emb", 31))
    proj = L.fc(input=emb, size=hid * 4, param_attr=attr("s_proj", 32))
    hidden, _ = L.dynamic_lstm(input=proj, size=hid * 4)
    last = L.sequence_last_step(input=hidden)
    pooled = L.sequence_pool(input=hidden, pool_type="average")
    feat = L.concat([last, pooled], axis=1)
    pred = L.fc(input=feat, size=3, act="softmax",
                param_attr=attr("s_out", 33))
    lens = [5, 3, 7]
    flat = np.random.RandomState(6).randint(0, vocab, (sum(lens), 1)) \
        .astype(np.int64)
    return ["words"], [pred], {"words": flat}, \
        {"words": np.cumsum([0] + lens)}


def crnn_ocr(fluid):
    """conv -> im2sequence -> bidirectional GRU -> CTC greedy decode;
    fetches the ragged decode and the encoder logits."""
    images = fluid.layers.data(name="images", shape=[1, 16, 32],
                               dtype="float32")
    main = fluid.default_main_program()
    decoded = _import(fluid, "ocr_crnn").ctc_infer(images, 7, hidden=12)
    logits = next(main.global_block().var(op.inputs["X"][0])
                  for op in reversed(main.global_block().ops)
                  if op.type == "softmax")
    xv = np.random.RandomState(4).rand(2, 1, 16, 32).astype(np.float32)
    return ["images"], [decoded, logits], {"images": xv}, {}


def kv_decoder(fluid, vocab=11, dim=8):
    """One attention decode step: (tok, k_cache, v_cache) -> (logits,
    k_all, v_all); the caches cross the C ABI every step."""
    L = fluid.layers

    def attr(name, seed, scale):
        return fluid.ParamAttr(name=name, initializer=fluid.initializer
                               .Normal(scale=scale, seed=seed))

    tok = L.data(name="tok", shape=[1], dtype="int64")
    kc = L.data(name="k_cache", shape=[dim], dtype="float32")
    vc = L.data(name="v_cache", shape=[dim], dtype="float32")
    emb = L.embedding(input=tok, size=[vocab, dim],
                      param_attr=attr("dec_emb", 21, 0.5))
    q, kn, vn = (L.fc(input=emb, size=dim, param_attr=attr(n, s, 0.4))
                 for n, s in (("w_q", 22), ("w_k", 23), ("w_v", 24)))
    k_all = L.concat([kc, kn], axis=0)
    v_all = L.concat([vc, vn], axis=0)
    att = L.softmax(L.scale(x=L.matmul(q, k_all, transpose_y=True),
                            scale=1.0 / np.sqrt(dim)))
    h = L.layer_norm(input=L.elementwise_add(x=L.matmul(att, v_all), y=emb),
                     begin_norm_axis=1)
    logits = L.fc(input=h, size=vocab, param_attr=attr("w_out", 25, 0.4))
    z = np.zeros((0, dim), np.float32)
    return ["tok", "k_cache", "v_cache"], [logits, k_all, v_all], \
        {"tok": np.array([[1]], np.int64), "k_cache": z, "v_cache": z}, {}


MODELS = {f.__name__: f for f in (mlp, conv, deepfm, padding_idx,
                                  lstm_sentiment, crnn_ocr, kv_decoder)}


def _save(fluid, build, dirname):
    """Build under fresh programs, init on the CPU, save the bundle.
    Returns (executor, scope, test program, feed names, fetch vars,
    feeds, lods)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        feeds, fetches, data, lods = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.executor.Scope()
    with fluid.executor.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(dirname, feeds, fetches, exe,
                                      main_program=main)
    test = main.clone(for_test=True)
    fetches = [test.global_block().var(v.name) for v in fetches]
    return exe, scope, test, feeds, fetches, data, lods


def _executor_run(fluid, saved, data, lods):
    exe, scope, test, _, fetches, _, _ = saved
    feed = {k: ((v, [np.asarray(lods[k], np.int32)]) if k in lods else v)
            for k, v in data.items()}
    with fluid.executor.scope_guard(scope):
        return [np.asarray(o) for o in
                exe.run(test, feed=feed, fetch_list=fetches)]


def _decode_steps(run, steps=6):
    """Greedy decode through a step function (the KV decoder's client
    loop); returns every step's outputs."""
    toks = [1]
    k = v = np.zeros((0, 8), np.float32)
    outs = []
    for _ in range(steps):
        lg, k, v = run({"tok": np.array([[toks[-1]]], np.int64),
                        "k_cache": k, "v_cache": v})
        outs.append((lg, k, v))
        toks.append(int(np.asarray(lg).reshape(-1).argmax()))
    return toks, outs


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_bundle_serves_the_executors_outputs(tmp_path, name):
    d = str(tmp_path / name)
    saved = _save(TF, MODELS[name], d)
    _, _, _, feeds, _, data, lods = saved
    runner = tnative.InferenceRunner(d)
    assert runner.feed_names == feeds
    assert runner.fetch_names == [v.name for v in saved[4]]
    if name == "kv_decoder":
        want_toks, want = _decode_steps(
            lambda f: _executor_run(TF, saved, f, {}))
        got_toks, got = _decode_steps(lambda f: runner.run(f))
        assert got_toks == want_toks and len(set(want_toks)) > 1
        for w, g in zip(want, got):
            for a, b in zip(w, g):
                np.testing.assert_allclose(b, a, **TOL)
        assert got[-1][1].shape == (6, 8)  # the cache grew through the ABI
        return
    want = _executor_run(TF, saved, data, lods)
    got, got_lods = runner.run(data, lods=lods, return_lod=True)
    assert len(got) == len(want)
    if name == "crnn_ocr":
        # the ragged decode: tokens and offsets exactly, logits to TOL
        dec, logits = want
        n_seq = 2
        seq_len = logits.shape[0] // n_seq
        oracle = []
        for s in range(n_seq):
            prev, out = -1, []
            for t in logits[s * seq_len:(s + 1) * seq_len].argmax(1):
                if t != 7 and t != prev:
                    out.append(int(t))
                prev = t
            oracle.append(out)
        off = got_lods[0]
        assert len(off) == n_seq + 1 and off[-1] == sum(map(len, oracle))
        assert [got[0][off[s]:off[s + 1], 0].astype(int).tolist()
                for s in range(n_seq)] == oracle
        # the Executor's fetch may hold rows past the last offset (its
        # LoD buffer's bucket); the tokens before it are the decode
        np.testing.assert_array_equal(
            got[0].reshape(-1), dec.reshape(-1)[:off[-1]].astype(np.float32))
        np.testing.assert_allclose(got[1], logits, **TOL)
        assert got_lods[1] == [0, seq_len, 2 * seq_len]  # one per image
        return
    for a, b in zip(want, got):
        assert b.shape == a.shape
        np.testing.assert_allclose(b, a, **TOL)
    assert all(lod == [] for lod in got_lods)
    runner.close()
    runner.close()  # closing twice is harmless


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_bundle_serves_the_jax_runners_outputs(tmp_path, name):
    d = str(tmp_path / name)
    _, _, _, _, _, data, lods = _save(JF, MODELS[name], d)
    mine = tnative.InferenceRunner(d)
    theirs = jnative.InferenceRunner(d)
    assert mine.feed_names == theirs.feed_names
    assert mine.fetch_names == theirs.fetch_names
    if name == "kv_decoder":
        a, wa = _decode_steps(lambda f: theirs.run(f))
        b, wb = _decode_steps(lambda f: mine.run(f))
        assert a == b
        for x, y in zip(wa, wb):
            for p, q in zip(x, y):
                np.testing.assert_array_equal(q, p)
        return
    want, want_lods = theirs.run(data, lods=lods, return_lod=True)
    got, got_lods = mine.run(data, lods=lods, return_lod=True)
    assert got_lods == want_lods
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b, a)


def test_runner_errors(tmp_path):
    with pytest.raises(IOError, match="cannot load inference bundle"):
        tnative.InferenceRunner(str(tmp_path / "nothing"))
    d = str(tmp_path / "m")
    _save(TF, mlp, d)
    runner = tnative.InferenceRunner(d)
    with pytest.raises(KeyError, match="lod for unknown input"):
        runner.run({}, lods={"nope": [0, 1]})


_BARE = textwrap.dedent("""
    import ctypes, sys
    import numpy as np

    so, bundle, x_path, out_path = sys.argv[1:5]
    assert not any(m.split(".")[0] in ("paddle_tpu_torch", "paddle_tpu",
                                       "torch", "jax") for m in sys.modules)
    L = ctypes.CDLL(so)
    L.ptpu_infer_create.restype = ctypes.c_void_p
    L.ptpu_infer_create.argtypes = [ctypes.c_char_p]
    L.ptpu_infer_set_input.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
    L.ptpu_infer_forward.argtypes = [ctypes.c_void_p]
    L.ptpu_infer_error.restype = ctypes.c_char_p
    L.ptpu_infer_error.argtypes = [ctypes.c_void_p]
    L.ptpu_infer_out_rank.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.ptpu_infer_out_shape.restype = ctypes.POINTER(ctypes.c_int64)
    L.ptpu_infer_out_shape.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.ptpu_infer_out_data.restype = ctypes.POINTER(ctypes.c_float)
    L.ptpu_infer_out_data.argtypes = [ctypes.c_void_p, ctypes.c_int]
    L.ptpu_infer_destroy.argtypes = [ctypes.c_void_p]
    h = L.ptpu_infer_create(bundle.encode())
    assert h, "create failed"
    x = np.load(x_path)
    shape = (ctypes.c_int64 * x.ndim)(*x.shape)
    L.ptpu_infer_set_input(h, b"x", x.ctypes.data_as(ctypes.c_void_p), 0,
                           shape, x.ndim)
    assert L.ptpu_infer_forward(h) == 0, L.ptpu_infer_error(h).decode()
    rank = L.ptpu_infer_out_rank(h, 0)
    shp = [L.ptpu_infer_out_shape(h, 0)[i] for i in range(rank)]
    out = np.ctypeslib.as_array(L.ptpu_infer_out_data(h, 0),
                                shape=(int(np.prod(shp)),)).reshape(shp)
    np.save(out_path, out)
    L.ptpu_infer_destroy(h)
    print("BARE-OK")
""")


def test_bare_interpreter_serves_the_bundle(tmp_path):
    """The capi acceptance: a fresh interpreter loads and forwards the
    port's bundle through dlopen and ctypes alone, with neither package
    (nor torch) imported."""
    d = str(tmp_path / "m")
    saved = _save(TF, mlp, d)
    x = saved[5]["x"]
    np.save(str(tmp_path / "x.npy"), x)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run(
        [sys.executable, "-c", _BARE, tnative.infer_lib_path(), d,
         str(tmp_path / "x.npy"), str(tmp_path / "out.npy")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BARE-OK" in res.stdout
    np.testing.assert_allclose(np.load(str(tmp_path / "out.npy")),
                               _executor_run(TF, saved, {"x": x}, {})[0],
                               **TOL)


_RACER = textwrap.dedent("""
    import os, sys, time
    import numpy as np

    root, bundle, go = sys.argv[1:4]
    sys.path.insert(0, root)
    import fresh.native as n

    while not os.path.exists(go):
        time.sleep(0.005)
    (out,) = n.InferenceRunner(bundle).run(
        {"x": np.ones((2, 8), np.float32)})
    print(n.infer_lib_path(), float(out.sum()))
""")


def test_four_processes_build_at_once(tmp_path):
    """Four processes build the runner at once on an empty `_build/` (a
    copy of the native package): each loads a whole library, all the
    same file, and no temporary file is left behind."""
    pkg = tmp_path / "fresh"
    (pkg / "native").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    src = os.path.join(ROOT, "paddle_tpu_torch", "native")
    for f in ("__init__.py", "inference.cc", "recordio.cc"):
        shutil.copy(os.path.join(src, f), str(pkg / "native" / f))
    d = str(tmp_path / "m")
    _save(TF, mlp, d)
    go = str(tmp_path / "go")
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(tmp_path),
                               d, go], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(4)]
    with open(go, "w"):
        pass
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(out.split())
    assert len({o[0] for o in outs}) == 1 and len({o[1] for o in outs}) == 1
    built = os.listdir(str(pkg / "_build"))
    assert built == [os.path.basename(outs[0][0])], built
    assert built[0].startswith("libptpu_infer-")


# --- merge_v2_model ----------------------------------------------------


def _v2_net(paddle):
    images = paddle.layer.data(name="pixel",
                               type=paddle.data_type.dense_vector(64))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    hidden = paddle.layer.fc(input=images, size=32,
                             act=paddle.activation.Relu())
    pred = paddle.layer.fc(input=hidden, size=10,
                           act=paddle.activation.Softmax())
    cost = paddle.layer.classification_cost(input=pred, label=label)
    return pred, cost


def _v2_tar(paddle, seed):
    """A v2 net and a tar of seeded weights written by `paddle`."""
    pred, cost = _v2_net(paddle)
    params = paddle.parameters.create(cost)
    rng = np.random.RandomState(seed)
    for k in params.keys():
        params[k] = rng.randn(*params.get_shape(k)).astype(np.float32) * .3
    buf = io.BytesIO()
    params.to_tar(buf)
    return pred, params, buf.getvalue()


@pytest.fixture
def v2_sides():
    import paddle_tpu.v2 as jpaddle
    import paddle_tpu_torch.v2 as tpaddle

    tpaddle.init(use_gpu=False)
    yield {"jax": jpaddle, "torch": tpaddle}
    tpaddle.init()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_merge_v2_model_from_either_tar(tmp_path, v2_sides, writer):
    from torch_legacy import fresh_names
    from paddle_tpu.utils.merge_model import merge_v2_model as jmerge
    from paddle_tpu_torch.utils.merge_model import merge_v2_model as tmerge

    tpaddle = v2_sides["torch"]
    with fresh_names():
        _, _, tar = _v2_tar(v2_sides[writer], 5)
    with fresh_names():
        tpred, _ = _v2_net(tpaddle)
    with fresh_names():
        jpred, _ = _v2_net(v2_sides["jax"])
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tar_path = str(tmp_path / "w.tar")
    with open(tar_path, "wb") as f:
        f.write(tar)
    assert tmerge(tpred, tar_path, tdir) == tdir
    jmerge(jpred, io.BytesIO(tar), jdir)
    x = np.random.RandomState(9).rand(6, 64).astype(np.float32)
    (got,) = tnative.InferenceRunner(tdir).run({"pixel": x})
    (want,) = jnative.InferenceRunner(jdir).run({"pixel": x})
    np.testing.assert_array_equal(got, want)
    params = tpaddle.parameters.Parameters.from_tar(io.BytesIO(tar))
    with fresh_names():
        tpred2, tcost = _v2_net(tpaddle)
    inferred = tpaddle.infer(output_layer=tpred2,
                             parameters=_into(tpaddle, tcost, params),
                             input=[(row,) for row in x])
    np.testing.assert_allclose(got, np.asarray(inferred), **TOL)
    assert np.allclose(got.sum(1), 1.0, atol=1e-5)


def _into(paddle, cost, loaded):
    params = paddle.parameters.create(cost)
    for k in params.keys():
        params[k] = loaded.get(k)
    return params


def test_merge_v2_model_refuses_a_tar_that_misses_a_parameter(tmp_path,
                                                              v2_sides):
    import tarfile

    from torch_legacy import fresh_names
    from paddle_tpu.utils.merge_model import merge_v2_model as jmerge
    from paddle_tpu_torch.utils.merge_model import merge_v2_model as tmerge

    with fresh_names():
        _, params, tar = _v2_tar(v2_sides["torch"], 6)
    dropped = sorted(params.keys())[0]
    short = io.BytesIO()
    with tarfile.open(fileobj=io.BytesIO(tar)) as src, \
            tarfile.open(fileobj=short, mode="w") as dst:
        for m in src.getmembers():
            if m.name.split(".protobuf")[0] != dropped:
                dst.addfile(m, src.extractfile(m))
    for side, merge in (("torch", tmerge), ("jax", jmerge)):
        with fresh_names():
            pred, _ = _v2_net(v2_sides[side])
        with pytest.raises(ValueError, match="does not cover the net") as e:
            merge(pred, io.BytesIO(short.getvalue()),
                  str(tmp_path / side))
        assert repr(dropped) in str(e.value)
