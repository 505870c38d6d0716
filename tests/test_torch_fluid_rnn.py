"""The ported recurrent kernels (kernels_rnn.py: lstm, gru, lstm_unit,
gru_unit, sequence_conv, lstmp) against the JAX package's on the same
numpy inputs and offsets (from a seed): their outputs called through
each package's registry (`run_both`), and their parameter gradients
through each package's executor (`FluidPair`, the same program and
startup weights, one SGD step).

Lengths include 1 and a longest sequence of 7 (no power of two).
Tolerances: outputs within atol/rtol 1e-5, gradients within atol 1e-5
and rtol 1e-4 (reduction order only); output offsets exact."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from test_torch_fluid_ops import TCtx, _op, run_both
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel

torch.set_num_threads(2)

R = np.random.RandomState(11)
LENS = [3, 1, 7, 5]
OFF = np.cumsum([0] + LENS).astype(np.int32)
TOTAL = int(OFF[-1])
N = len(LENS)
H = 4


def f32(*shape, scale=0.5):
    return (scale * R.randn(*shape)).astype(np.float32)


def assert_same(j, t, slots=None, atol=1e-5, rtol=1e-5):
    for slot in slots or j:
        for a, b in zip(j[slot], t[slot]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if a.dtype.kind in "iu":
                np.testing.assert_array_equal(b, a, err_msg=slot)
            else:
                np.testing.assert_allclose(b, a, atol=atol, rtol=rtol,
                                           err_msg=slot)


LSTM = {
    "peepholes": dict(bias=7, attrs=dict(use_peepholes=True)),
    "no_peepholes": dict(bias=4, attrs=dict(use_peepholes=False)),
    "reverse": dict(bias=7, attrs=dict(use_peepholes=True,
                                       is_reverse=True)),
    "h0_c0_reverse": dict(bias=7, state=True, attrs=dict(
        use_peepholes=True, is_reverse=True)),
    "no_bias_relu_identity": dict(bias=0, attrs=dict(
        use_peepholes=False, cell_activation="relu",
        candidate_activation="identity")),
}


@pytest.mark.parametrize("case", sorted(LSTM))
def test_lstm(case):
    c = LSTM[case]
    ins = {"Input": [f32(TOTAL, 4 * H)], "Weight": [f32(H, 4 * H)]}
    if c["bias"]:
        ins["Bias"] = [f32(1, c["bias"] * H)]
    if c.get("state"):
        ins["H0"] = [f32(N, H)]
        ins["C0"] = [f32(N, H)]
    j, t, _ = run_both("lstm", ins, c["attrs"], lods={"Input": OFF})
    assert_same(j, t)


def test_lstm_without_host_offsets_takes_the_fed_maximum():
    """Offsets only the device knows (computed from data): the time
    extent falls back to the run's longest fed sequence, and the output
    is the same."""
    ins = {"Input": [f32(TOTAL, 4 * H)], "Weight": [f32(H, 4 * H)],
           "Bias": [f32(1, 7 * H)]}
    j, t, _ = run_both("lstm", ins, {}, lods={"Input": OFF}, host=False)
    assert_same(j, t)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("h0", [False, True])
def test_gru(reverse, h0):
    ins = {"Input": [f32(TOTAL, 3 * H)], "Weight": [f32(H, 3 * H)],
           "Bias": [f32(1, 3 * H)]}
    if h0:
        ins["H0"] = [f32(N, H)]
    j, t, _ = run_both("gru", ins, dict(is_reverse=reverse),
                       lods={"Input": OFF})
    assert_same(j, t)


def test_lstm_unit():
    j, t, _ = run_both("lstm_unit", {"X": [f32(N, 4 * H)],
                                     "C_prev": [f32(N, H)]},
                       dict(forget_bias=0.5))
    assert_same(j, t)


def test_gru_unit():
    j, t, _ = run_both("gru_unit", {
        "Input": [f32(N, 3 * H)], "HiddenPrev": [f32(N, H)],
        "Weight": [f32(H, 3 * H)], "Bias": [f32(1, 3 * H)]},
        dict(activation="relu"))
    assert_same(j, t)


@pytest.mark.parametrize("cl,cs", [(3, -1), (4, 0)])
def test_sequence_conv(cl, cs):
    j, t, _ = run_both("sequence_conv", {"X": [f32(TOTAL, 3)],
                                         "Filter": [f32(cl * 3, 5)]},
                       dict(contextLength=cl, contextStart=cs),
                       lods={"X": OFF})
    assert_same(j, t)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstmp(reverse):
    P = 3
    j, t, _ = run_both("lstmp", {
        "Input": [f32(TOTAL, 4 * H)], "Weight": [f32(P, 4 * H)],
        "ProjWeight": [f32(H, P)], "Bias": [f32(1, 7 * H)]},
        dict(is_reverse=reverse), lods={"Input": OFF},
        outs=["Projection", "Cell"])
    assert_same(j, t)


def test_lstm_loop_has_no_host_read():
    """The time loop reads nothing back from the device: the kernel's
    forward and backward run on tensors that refuse to become Python
    values (a CPU stand-in for the card's sync check in chip_smoke.py,
    which also catches reads inside torch, such as a boolean mask
    index, under torch.cuda.set_sync_debug_mode)."""
    ctx = TCtx(None, None, "cpu")
    ctx.op = _op({"Input": [0], "Weight": [0], "Bias": [0]})
    off = torch.from_numpy(OFF.copy())
    ctx.env = {"Input@LOD0": off}
    ctx.note_host_lod(off, OFF)
    x = torch.from_numpy(f32(TOTAL, 4 * H)).requires_grad_(True)
    w = torch.from_numpy(f32(H, 4 * H)).requires_grad_(True)
    b = torch.from_numpy(f32(1, 7 * H)).requires_grad_(True)

    def refuse(*a, **k):
        raise AssertionError("host read inside the lstm kernel")

    saved = {m: getattr(torch.Tensor, m) for m in
             ("item", "tolist", "numpy", "nonzero", "__bool__",
              "__int__", "__float__", "__index__")}
    try:
        for m in saved:
            setattr(torch.Tensor, m, refuse)
        out = tkernel("lstm")(ctx, {"Input": [x], "Weight": [w],
                                    "Bias": [b]}, {})
        grads = torch.autograd.grad(out["Hidden"].sum()
                                    + out["Cell"].sum(), [x, w, b])
    finally:
        for m, f in saved.items():
            setattr(torch.Tensor, m, f)
    assert all(torch.isfinite(g).all() for g in grads)


# --- gradients through the executor ------------------------------------

def _seq_data(fluid, width):
    return fluid.layers.data(name="x", shape=[width], dtype="float32",
                             lod_level=1)


def _head(fluid, seq):
    pooled = fluid.layers.sequence_pool(input=seq, pool_type="sum")
    return fluid.layers.mean(x=pooled)


PROGRAMS = {
    "dynamic_lstm_peepholes_reverse": lambda f, x: f.layers.dynamic_lstm(
        input=f.layers.fc(input=x, size=4 * H), size=4 * H,
        is_reverse=True)[0],
    "dynamic_lstm_no_peepholes": lambda f, x: f.layers.dynamic_lstm(
        input=f.layers.fc(input=x, size=4 * H), size=4 * H,
        use_peepholes=False)[1],
    "dynamic_gru": lambda f, x: f.layers.dynamic_gru(
        input=f.layers.fc(input=x, size=3 * H), size=H),
    "dynamic_gru_reverse": lambda f, x: f.layers.dynamic_gru(
        input=f.layers.fc(input=x, size=3 * H), size=H, is_reverse=True),
    "dynamic_lstmp": lambda f, x: f.layers.dynamic_lstmp(
        input=f.layers.fc(input=x, size=4 * H), size=4 * H,
        proj_size=3)[0],
    "sequence_conv": lambda f, x: f.layers.sequence_conv(
        input=x, num_filters=5, filter_size=3, act="tanh"),
}


def _grads_alike(build, feed):
    pair = tp.FluidPair(build)
    jparams = [p.name for p in pair.jmain.global_block().all_parameters()]
    fetch = ["loss"] + ["g%d" % i for i in range(len(jparams))]
    for i, p in enumerate(jparams):
        pair.jvars["g%d" % i] = p + "@GRAD"
        pair.tvars["g%d" % i] = pair.names[p] + "@GRAD"
    j, t = pair.run(feed, fetch)
    np.testing.assert_allclose(t[0], j[0], rtol=1e-4)
    for name, a, b in zip(jparams, j[1:], t[1:]):
        assert np.abs(a).max() > 0, name
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(PROGRAMS))
def test_gradients_through_the_executor(case):
    def build(fluid, resnet):
        loss = _head(fluid, PROGRAMS[case](fluid, _seq_data(fluid, 3)))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss)

    _grads_alike(build, {"x": (f32(TOTAL, 3, scale=1.0), [OFF])})


@pytest.mark.parametrize("cell", ["lstm_unit", "gru_unit"])
def test_unit_gradients_through_the_executor(cell):
    def build(fluid, resnet):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        h = fluid.layers.data(name="h", shape=[H], dtype="float32")
        c = fluid.layers.data(name="c", shape=[H], dtype="float32")
        if cell == "lstm_unit":
            out, _ = fluid.layers.lstm_unit(x_t=x, hidden_t_prev=h,
                                            cell_t_prev=c)
        else:
            out = fluid.layers.gru_unit(
                input=fluid.layers.fc(input=x, size=3 * H), hidden=h,
                size=3 * H)[0]
        loss = fluid.layers.mean(x=out)
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
        return dict(loss=loss)

    _grads_alike(build, {"x": f32(N, 3, scale=1.0), "h": f32(N, H),
                         "c": f32(N, H)})
