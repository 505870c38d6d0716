"""Each ported sequence (LoD) op kernel — the 19 of kernels_sequence.py,
and row_conv and im2sequence of kernels_tensor.py — against the JAX
package's kernel of the same op on the same numpy inputs and offsets
(from a seed), called directly through each package's registry on the
CPU (`run_both` of test_torch_fluid_ops.py, with side-bands).

Tolerances: float outputs within atol/rtol 1e-5 (reduction order only);
output offsets and integer outputs exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.fluid.core.registry import get_kernel as jkernel
from paddle_tpu_torch.fluid.core.registry import get_kernel as tkernel
from test_torch_fluid_ops import JCtx, TCtx, _op, run_both

torch.set_num_threads(2)

R = np.random.RandomState(8)
LENS = [3, 1, 7, 5]  # a length 1; longest 7, no power of two
OFF = np.cumsum([0] + LENS).astype(np.int32)
TOTAL = int(OFF[-1])
OFF_EMPTY = np.asarray([0, 3, 3, 10], np.int32)  # an empty sequence


def f32(*shape):
    return R.randn(*shape).astype(np.float32)


def assert_same(j, t, slots=None):
    for slot in slots or j:
        assert slot in t, slot
        for a, b in zip(j[slot], t[slot]):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (slot, a.shape, b.shape)
            if a.dtype.kind in "iub":
                np.testing.assert_array_equal(b.astype(np.int64),
                                              a.astype(np.int64),
                                              err_msg=slot)
            else:
                np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5,
                                           err_msg=slot)


@pytest.mark.parametrize("ptype", ["SUM", "AVERAGE", "SQRT", "MAX",
                                   "FIRST", "LAST"])
@pytest.mark.parametrize("off", [OFF, OFF_EMPTY], ids=["ragged", "empty"])
def test_sequence_pool(ptype, off):
    j, t, _ = run_both("sequence_pool", {"X": [f32(int(off[-1]), 4)]},
                       dict(pooltype=ptype), lods={"X": off})
    assert_same(j, t, ["Out"])


def test_every_sequence_rnn_and_ctc_op_is_ported():
    """Each op the JAX package's kernels_sequence, kernels_rnn and
    kernels_ctc register (and row_conv, im2sequence) has a port kernel
    in the module of the same name."""
    from paddle_tpu.fluid.core import registry as jreg
    from paddle_tpu_torch.fluid.core import registry as treg

    want = {op: fn.__module__.rsplit(".", 1)[1]
            for op, fn in jreg._KERNELS.items()
            if fn.__module__.rsplit(".", 1)[1] in (
                "kernels_sequence", "kernels_rnn", "kernels_ctc")}
    want.update(row_conv="kernels_tensor", im2sequence="kernels_tensor")
    assert len(want) == 19 + 6 + 3 + 2
    have = {op: treg._KERNELS[op].__module__.rsplit(".", 1)[1]
            for op in want if op in treg._KERNELS}
    assert have == want


def test_missing_lod_raises_the_same_error():
    msgs = []
    for kernel, ctx in ((jkernel, JCtx(None, None)),
                        (tkernel, TCtx(None, None, "cpu"))):
        ctx.op = _op({"X": [0]})
        ctx.op.type = "sequence_pool"
        with pytest.raises(ValueError) as e:
            kernel("sequence_pool")(ctx, {"X": [None]}, {})
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "no LoD offsets" in msgs[0]


def test_sequence_softmax():
    j, t, _ = run_both("sequence_softmax", {"X": [f32(TOTAL, 1)]}, {},
                       lods={"X": OFF}, outs=["Out"])
    assert_same(j, t)


EXPAND = {
    # dense X: row i repeats over Y's sequence i
    "rows": dict(x=(4, 3), x_lod=None),
    # lod-level-1 X, each sequence of length 1
    "lod_x": dict(x=(4, 3), x_lod=np.arange(5, dtype=np.int32)),
}


@pytest.mark.parametrize("case", sorted(EXPAND))
def test_sequence_expand(case):
    c = EXPAND[case]
    lods = {"Y": OFF}
    if c["x_lod"] is not None:
        lods["X"] = c["x_lod"]
    j, t, _ = run_both("sequence_expand", {"X": [f32(*c["x"])],
                                           "Y": [f32(TOTAL, 2)]}, {},
                       lods=lods, outs=["Out"])
    assert_same(j, t)


def test_sequence_expand_follows_beam_parents():
    parents = np.asarray([2, 0, 0, 1, 3, 3], np.int32)
    j, t, _ = run_both("sequence_expand", {"X": [f32(4, 3)],
                                           "Y": [f32(6, 1)]}, {},
                       lods={"Y": np.asarray([0, 2, 6], np.int32)},
                       env={"Y@BEAM_PARENTS": parents}, outs=["Out"])
    assert_same(j, t)


def test_sequence_concat():
    j, t, _ = run_both("sequence_concat", {"X": [f32(TOTAL, 2),
                                                 f32(TOTAL, 3)]}, {},
                       lods={"X0": OFF}, outs=["Out"])
    assert_same(j, t)


Y_OFF = np.asarray([0, 4, 16], np.int32)
LOD_RESET = {
    "y_lod": dict(ins=lambda: {"X": [f32(TOTAL, 2)], "Y": [f32(TOTAL, 1)]},
                  lods={"Y": np.asarray([0, 8, 16], np.int32)}, attrs={},
                  env={}),
    # Y's values are the offsets (the JAX kernel reads them from its
    # environment, where its executor keeps every value)
    "y_values": dict(ins=lambda: {"X": [f32(TOTAL, 2)], "Y": [Y_OFF]},
                     lods={}, attrs={}, env={"Y": Y_OFF}),
    "target_lod": dict(ins=lambda: {"X": [f32(TOTAL, 2)]}, lods={},
                       attrs=dict(target_lod=[0, 5, 9, 16]), env={}),
}


@pytest.mark.parametrize("case", sorted(LOD_RESET))
def test_lod_reset(case):
    c = LOD_RESET[case]
    j, t, _ = run_both("lod_reset", c["ins"](), c["attrs"], lods=c["lods"],
                       env=c["env"], outs=["Out"])
    assert_same(j, t)


@pytest.mark.parametrize("new_dim", [2, 8])
def test_sequence_reshape(new_dim):
    off = np.asarray([0, 2, 4, 10], np.int32)  # even lengths: 4*len/8
    j, t, _ = run_both("sequence_reshape", {"X": [f32(10, 4)]},
                       dict(new_dim=new_dim), lods={"X": off},
                       outs=["Out"])
    assert_same(j, t)


def test_sequence_slice():
    j, t, _ = run_both("sequence_slice", {
        "X": [f32(TOTAL, 3)],
        "Offset": [np.asarray([[1], [0], [2], [0]], np.int64)],
        "Length": [np.asarray([[2], [1], [4], [5]], np.int64)]}, {},
        lods={"X": OFF}, outs=["Out"])
    assert_same(j, t)


def test_sequence_erase():
    x = R.randint(0, 5, (TOTAL, 1)).astype(np.int32)
    j, t, _ = run_both("sequence_erase", {"X": [x]}, dict(tokens=[0, 3]),
                       lods={"X": OFF}, outs=["Out"])
    assert_same(j, t)


def test_sequence_reverse():
    j, t, _ = run_both("sequence_reverse", {"X": [f32(TOTAL, 3)]}, {},
                       lods={"X": OFF}, outs=["Out"])
    assert_same(j, t)


@pytest.mark.parametrize("cl,cs", [(3, -1), (4, -2), (2, 0)])
def test_sequence_context(cl, cs):
    j, t, _ = run_both("sequence_context", {"X": [f32(TOTAL, 3)]},
                       dict(context_length=cl, context_start=cs),
                       lods={"X": OFF}, outs=["Out"])
    assert_same(j, t)


@pytest.mark.parametrize("beam", [3, TOTAL + 2])
def test_kmax_seq_score(beam):
    j, t, _ = run_both("kmax_seq_score", {"X": [f32(TOTAL, 1)]},
                       dict(beam_size=beam), lods={"X": OFF})
    assert_same(j, t)


def test_sub_nested_seq():
    # 2 outer sequences over 5 sub-sequences of 16 tokens
    tok_off = np.asarray([0, 2, 5, 6, 11, 16], np.int32)
    outer = np.asarray([0, 2, 5], np.int32)
    sel = np.asarray([[1, -1], [2, 0]], np.int32)
    j, t, _ = run_both("sub_nested_seq", {"X": [f32(TOTAL, 2)],
                                          "S": [sel]}, {},
                       lods={"X": tok_off}, env={"X@LOD_SRC": outer},
                       outs=["Out"])
    assert_same(j, t)


def _lambda_rank_grads(x, score):
    """d sum(out * w)/dX through each package's lambda_rank kernel."""
    w = R.rand(TOTAL, 1).astype(np.float32)
    jctx = JCtx(None, None)
    jctx.op = _op({"X": [x], "Score": [score]}, outs=["Out"])
    jctx.op.type = "lambda_rank"
    jctx.env = {"X@LOD0": jnp.asarray(OFF)}
    jk = jkernel("lambda_rank")

    def jf(xx):
        out = jk(jctx, {"X": [xx], "Score": [jnp.asarray(score)]},
                 dict(NDCG_num=3))["Out"]
        return jnp.sum(out * w)

    jg = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    tctx = TCtx(None, None, "cpu")
    tctx.op = jctx.op
    tctx.env = {"X@LOD0": torch.from_numpy(OFF.copy())}
    tx = torch.from_numpy(x.copy()).requires_grad_(True)
    out = tkernel("lambda_rank")(tctx, {"X": [tx], "Score": [
        torch.from_numpy(score.copy())]}, dict(NDCG_num=3))["Out"]
    (tg,) = torch.autograd.grad((out * torch.from_numpy(w)).sum(), tx)
    return jg, tg.numpy()


def test_lambda_rank_cost_and_lambda_gradient():
    x = f32(TOTAL, 1)
    score = R.randint(0, 4, (TOTAL, 1)).astype(np.float32)
    j, t, _ = run_both("lambda_rank", {"X": [x], "Score": [score]},
                       dict(NDCG_num=3), lods={"X": OFF})
    assert_same(j, t)
    jg, tg = _lambda_rank_grads(x, score)
    np.testing.assert_allclose(tg, jg, atol=1e-5, rtol=1e-5)


def test_cross_entropy_over_beam():
    offs = [OFF, np.asarray([0, 2, 6, 7, 9], np.int32)]
    j, t, _ = run_both("cross_entropy_over_beam", {
        "Scores": [f32(TOTAL, 1), f32(9, 1)],
        "Gold": [np.asarray([[2], [0], [6], [1]], np.int64),
                 np.asarray([[1], [3], [0], [1]], np.int64)]}, {},
        lods={"Scores0": offs[0], "Scores1": offs[1]})
    assert_same(j, t)


TIES = np.asarray([0, 2, 5, 7, 12, 13], np.int32)  # lengths 2,3,2,5,1


def test_lod_rank_table_is_a_stable_sort():
    j, t, _ = run_both("lod_rank_table", {"X": [f32(13, 2)]}, {},
                       lods={"X": TIES})
    assert_same(j, t)


def test_max_sequence_len():
    table = np.asarray([[3, 5], [1, 3], [0, 2]], np.int32)
    j, t, _ = run_both("max_sequence_len", {"RankTable": [table]}, {})
    assert_same(j, t)


def test_reorder_lod_tensor_by_rank():
    table = np.asarray([[3, 5], [1, 3], [0, 2], [2, 2], [4, 1]], np.int32)
    j, t, _ = run_both("reorder_lod_tensor_by_rank",
                       {"X": [f32(13, 2)], "RankTable": [table]}, {},
                       lods={"X": TIES}, outs=["Out"])
    assert_same(j, t)


def test_split_and_merge_lod_tensor():
    x = f32(7, 3)
    mask = np.asarray([[1], [0], [0], [1], [1], [0], [1]], bool)
    j, t, _ = run_both("split_lod_tensor", {"X": [x], "Mask": [mask]}, {},
                       outs=["OutTrue", "OutFalse"])
    assert_same(j, t)
    j2, t2, _ = run_both("merge_lod_tensor", {
        "InTrue": [j["OutTrue"][0]], "InFalse": [j["OutFalse"][0]],
        "Mask": [mask], "X": [x]}, {})
    assert_same(j2, t2)
    np.testing.assert_array_equal(t2["Out"][0], x)


ROW_CONV = {
    "packed_lod": dict(x=(TOTAL, 3), lods={"X": OFF}),
    "packed_one_sequence": dict(x=(TOTAL, 3), lods={}),
    "dense_batch": dict(x=(2, 6, 3), lods={}),
}


@pytest.mark.parametrize("case", sorted(ROW_CONV))
def test_row_conv(case):
    c = ROW_CONV[case]
    j, t, _ = run_both("row_conv", {"X": [f32(*c["x"])],
                                    "Filter": [f32(3, 3)]}, {},
                       lods=c["lods"])
    assert_same(j, t)


IM2SEQ = {
    "k2x3_s1x2_pad": dict(x=(2, 3, 5, 7), attrs=dict(
        kernels=[2, 3], strides=[1, 2], paddings=[1, 0, 1, 1])),
    "full_height_columns": dict(x=(3, 4, 2, 6), attrs=dict(
        kernels=[2, 1], strides=[1, 1])),
}


@pytest.mark.parametrize("case", sorted(IM2SEQ))
def test_im2sequence(case):
    c = IM2SEQ[case]
    j, t, _ = run_both("im2sequence", {"X": [f32(*c["x"])]}, c["attrs"],
                       outs=["Out"])
    assert_same(j, t)
