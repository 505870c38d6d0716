"""The port's v2 API (paddle_tpu_torch.v2) against the JAX package's: the
same v2 network built through each, parameters crossing as a v2 tar, then
`SGD.train` with its events, `SGD.test` and `infer` on synthetic readers
made from a seed. The tar format is the JAX package's byte for byte.

Tolerances: per-batch costs, test costs and metrics rtol 1e-5, atol
1e-6; inferred values and trained parameters rtol 1e-5, atol 1e-6 (every
optimizer here is SGD or Momentum)."""

import io

import numpy as np
import pytest

import paddle_tpu_torch.v2 as tpaddle


@pytest.fixture(autouse=True)
def _cpu():
    tpaddle.init(use_gpu=False)
    yield
    tpaddle.init()


def _reader(kind, n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            if kind == "line":
                x = rng.randn(13).astype("float32")
                yield x, np.array([x[:3].sum()], "float32")
            elif kind == "digits":
                lab = int(rng.randint(0, 10))
                img = rng.rand(64).astype("float32") * 0.1
                img[lab::10] += 0.5
                yield img, lab
            elif kind == "seq":
                words = rng.randint(0, 30, rng.randint(2, 7)).tolist()
                yield words, int(words[0] % 2)
            else:  # sparse
                idxs = sorted(set(map(int, rng.randint(0, 50, 3))))
                yield idxs, np.array([float(len(idxs))], "float32")
    return reader


def fit_a_line(paddle):
    x = paddle.layer.data(name="x", type=paddle.data_type.dense_vector(13))
    y = paddle.layer.data(name="y", type=paddle.data_type.dense_vector(1))
    pred = paddle.layer.fc(input=x, size=1)
    return dict(cost=paddle.layer.mse_cost(input=pred, label=y), out=pred,
                opt=paddle.optimizer.Momentum(momentum=0.9,
                                              learning_rate=1e-2))


def digits(paddle):
    images = paddle.layer.data(name="pixel",
                               type=paddle.data_type.dense_vector(64))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    hidden = paddle.layer.fc(input=images, size=32,
                             act=paddle.activation.Relu())
    pred = paddle.layer.fc(input=hidden, size=10,
                           act=paddle.activation.Softmax())
    return dict(cost=paddle.layer.classification_cost(input=pred,
                                                      label=label),
                out=pred,
                extra=[paddle.evaluator.classification_error(
                    input=pred, label=label, name="err")],
                opt=paddle.optimizer.Momentum(momentum=0.9,
                                              learning_rate=0.1))


def sequence(paddle):
    data = paddle.layer.data(
        name="word", type=paddle.data_type.integer_value_sequence(30))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(2))
    emb = paddle.layer.embedding(input=data, size=8)
    lstm = paddle.layer.simple_lstm(input=emb, size=6)
    pooled = paddle.layer.pooling(input=lstm, pooling_type="max")
    out = paddle.layer.fc(input=pooled, size=2,
                          act=paddle.activation.Softmax())
    return dict(cost=paddle.layer.classification_cost(input=out,
                                                      label=label),
                out=out, opt=paddle.optimizer.SGD(learning_rate=0.2))


def sparse(paddle):
    sx = paddle.layer.data(name="sx",
                           type=paddle.data_type.sparse_binary_vector(50))
    sy = paddle.layer.data(name="sy", type=paddle.data_type.dense_vector(1))
    pred = paddle.layer.fc(input=sx, size=1)
    return dict(cost=paddle.layer.mse_cost(input=pred, label=sy), out=pred,
                opt=paddle.optimizer.SGD(learning_rate=0.1))


NETS = {"fit_a_line": (fit_a_line, "line", 16),
        "digits": (digits, "digits", 16),
        "sequence": (sequence, "seq", 4),
        "sparse": (sparse, "sparse", 4)}


def _side(paddle, build, kind, batch, init_tar=None):
    """Build, (optionally) load weights from a tar, train 2 passes,
    test, infer. Returns what the two packages are compared on."""
    net = build(paddle)
    params = paddle.parameters.create(net["cost"])
    if init_tar is not None:
        params.init_from_tar(io.BytesIO(init_tar))
    tar0 = io.BytesIO()
    params.to_tar(tar0)
    trainer = paddle.trainer.SGD(cost=net["cost"], parameters=params,
                                 update_equation=net["opt"],
                                 extra_layers=net.get("extra"))
    events = []

    def handler(e):
        if isinstance(e, paddle.event.EndIteration):
            events.append((e.pass_id, e.batch_id, e.cost,
                           dict(e.evaluator or {})))
        elif isinstance(e, (paddle.event.BeginPass, paddle.event.EndPass)):
            events.append((type(e).__name__, e.pass_id))

    trainer.train(reader=paddle.batch(_reader(kind, 4 * batch, 0), batch),
                  num_passes=2, event_handler=handler)
    result = trainer.test(reader=paddle.batch(_reader(kind, 2 * batch, 1),
                                              batch))
    items = [(s[0],) for s in _reader(kind, 5, 2)()]
    inferred = paddle.infer(output_layer=net["out"], parameters=params,
                            input=items)
    return dict(tar0=tar0.getvalue(), events=events, test=result,
                infer=np.asarray(inferred),
                params={k: params[k] for k in params.keys()})


def _close(a, b, what):
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6, err_msg=what)


@pytest.mark.parametrize("name", sorted(NETS))
def test_sgd_train_test_infer_match_the_jax_package(name):
    import paddle_tpu.v2 as jpaddle
    from torch_legacy import fresh_names

    build, kind, batch = NETS[name]
    with fresh_names():
        j = _side(jpaddle, build, kind, batch)
    with fresh_names():
        t = _side(tpaddle, build, kind, batch, init_tar=j["tar0"])
    # the port's tar of the same weights is the JAX package's, byte for
    # byte
    assert t["tar0"] == j["tar0"]
    assert len(t["events"]) == len(j["events"]) == 2 * 4 + 4
    for je, te in zip(j["events"], t["events"]):
        if isinstance(je[0], str):
            assert je == te
            continue
        assert je[:2] == te[:2]
        _close(je[2], te[2], "cost of %r" % (je[:2],))
        assert sorted(je[3]) == sorted(te[3])
        for k in je[3]:
            _close(je[3][k], te[3][k], "metric %s" % k)
    _close(j["test"].cost, t["test"].cost, "test cost")
    assert sorted(j["test"].evaluator) == sorted(t["test"].evaluator)
    for k in j["test"].evaluator:
        _close(j["test"].evaluator[k], t["test"].evaluator[k], k)
    _close(j["infer"], t["infer"], "infer")
    assert sorted(j["params"]) == sorted(t["params"])
    for k in j["params"]:
        _close(j["params"][k], t["params"][k], k)


def test_tar_round_trips_between_the_packages():
    """A tar written by either package loads in the other, and writing
    back what was loaded gives the same bytes."""
    import paddle_tpu.v2 as jpaddle
    from torch_legacy import fresh_names

    with fresh_names():
        jp = jpaddle.parameters.create(digits(jpaddle)["cost"])
    rng = np.random.RandomState(3)
    for k in jp.keys():
        jp[k] = rng.randn(*jp.get_shape(k)).astype(np.float32)
    jt = io.BytesIO()
    jp.to_tar(jt)
    tp = tpaddle.parameters.Parameters.from_tar(io.BytesIO(jt.getvalue()))
    tt = io.BytesIO()
    tp.to_tar(tt)
    assert tt.getvalue() == jt.getvalue()
    back = jpaddle.parameters.Parameters.from_tar(io.BytesIO(tt.getvalue()))
    for k in jp.keys():
        np.testing.assert_array_equal(back[k], jp[k])
        np.testing.assert_array_equal(tp[k], jp[k])
    with fresh_names():
        tq = tpaddle.parameters.create(digits(tpaddle)["cost"])
    tq.init_from_tar(io.BytesIO(jt.getvalue()))
    for k in jp.keys():
        np.testing.assert_array_equal(tq[k], jp[k])


def test_test_leaves_parameters_untouched():
    net = fit_a_line(tpaddle)
    params = tpaddle.parameters.create(net["cost"])
    trainer = tpaddle.trainer.SGD(cost=net["cost"], parameters=params,
                                  update_equation=net["opt"])
    before = {k: params[k].copy() for k in params.keys()}
    r1 = trainer.test(reader=tpaddle.batch(_reader("line", 8, 0), 4))
    r2 = trainer.test(reader=tpaddle.batch(_reader("line", 8, 0), 4))
    for k in params.keys():
        np.testing.assert_array_equal(before[k], params[k])
    assert r1.cost == r2.cost


def test_v2_runs_on_the_card_unless_init_says_cpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    tpaddle.init()
    net = fit_a_line(tpaddle)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpaddle.parameters.create(net["cost"])
    assert isinstance(tpaddle.place(), tpaddle.fluid.CUDAPlace)
    tpaddle.init(use_gpu=False)
    assert isinstance(tpaddle.place(), tpaddle.fluid.CPUPlace)


def test_init_refuses_more_than_one_trainer():
    """paddle.init(trainer_count=4) is accepted and ignored, as the JAX
    package's init is: both return None, `use_gpu=False` still places
    the API on the CPU, and SGD then trains exactly as at
    trainer_count=1 (the name is the test's from when the port
    refused)."""
    import paddle_tpu.v2 as jpaddle
    from torch_legacy import fresh_names

    assert jpaddle.init(use_gpu=False, trainer_count=4) is None
    runs = {}
    for n in (4, 1):
        assert tpaddle.init(use_gpu=False, trainer_count=n) is None
        assert isinstance(tpaddle.place(), tpaddle.fluid.CPUPlace)
        with fresh_names():
            tar0 = runs[4]["tar0"] if n == 1 else None
            runs[n] = _side(tpaddle, fit_a_line, "line", 16, init_tar=tar0)
    assert runs[1]["tar0"] == runs[4]["tar0"]
    assert runs[1]["events"] == runs[4]["events"]
    np.testing.assert_array_equal(runs[1]["infer"], runs[4]["infer"])
    for k in runs[1]["params"]:
        np.testing.assert_array_equal(runs[1]["params"][k],
                                      runs[4]["params"][k])


def test_surface_and_what_is_left_out():
    """The v2 modules the port has are there (the ones that share the
    DSL's objects load at first use; master since the data plane;
    dataset, image and plot since the datasets were ported)."""
    for name in ("activation", "attr", "data_type", "evaluator", "event",
                 "layer", "master", "minibatch", "networks", "op",
                 "optimizer", "parameters", "pooling", "reader", "trainer"):
        assert getattr(tpaddle, name).__name__ == \
            "paddle_tpu_torch.v2." + name
    assert tpaddle.attr.Param is tpaddle.attr.ParamAttr
    assert tpaddle.pooling.Max().name == "max"
    for name in ("dataset", "image", "plot"):
        assert getattr(tpaddle, name).__name__ == \
            "paddle_tpu_torch.v2." + name
    assert tpaddle.dataset.mnist.__name__ == \
        "paddle_tpu_torch.v2.dataset.mnist"
    assert tpaddle.plot.Ploter and tpaddle.image.simple_transform
    from paddle_tpu_torch.v2 import data_feeder, inference

    feeder = data_feeder.DataFeeder(
        [("x", tpaddle.data_type.dense_vector(2)),
         ("y", tpaddle.data_type.integer_value(3))])
    feed = feeder([(np.ones(2, "float32"), 1), (np.zeros(2, "float32"), 2)])
    assert feed["x"].shape == (2, 2) and feed["y"].tolist() == [[1], [2]]
    assert inference.Inference.__name__ == "Inference"
