"""The pieces of the output check on the CPU: which leaves a training cell
compares, the lower-precision references, and what a serving run counts
as failed."""

import math

import pytest
import torch

from perfbench.lib import compare, harness, lowp
from perfbench.tests.small import small_cell


def _readings(grad, change, keep=None):
    out = {"loss": [1.0], "grad_norms": torch.tensor(grad),
           "change_norms": torch.tensor(change)}
    if keep is not None:
        out["keep_norms"] = torch.tensor(keep)
    return out


def test_a_leaf_whose_update_rounds_away_on_both_sides_is_compared():
    # leaf 0 has a gradient, but its stored update is 0 on both sides
    ref = _readings([0.0, 1.0, 2.0], [0.0, 1.0, 2.0], keep=[1.0, 1.0, 2.0])
    prog = _readings([0.0, 1.0, 2.0], [0.0, 1.0, 2.0])
    assert compare.worst_leaves(prog, ref)["kept"] == 3
    assert compare.train_gaps(prog, ref)["grad_gap"] == 0.0
    # the program moving it where the reference does not reads a gap
    moved = _readings([0.5, 1.0, 2.0], [0.5, 1.0, 2.0])
    assert compare.train_gaps(moved, ref)["grad_gap"] == pytest.approx(0.5)


def test_a_leaf_with_a_nought_gradient_is_left_out():
    ref = _readings([1e-9, 1.0, 2.0], [1e-9, 1.0, 2.0], keep=[1e-9, 1.0, 2.0])
    prog = _readings([0.7, 1.0, 2.0], [0.7, 1.0, 2.0])
    assert compare.worst_leaves(prog, ref)["kept"] == 2
    assert compare.train_gaps(prog, ref)["grad_gap"] == 0.0


@pytest.mark.parametrize("low,fmt_err", [
    ((lowp.bf16_matmul, lowp.bf16), 2.0 ** -8),
    ((lowp.fp8_matmul, lowp.q8), 2.0 ** -3)])
def test_low_precision_products_round_operands_and_gradients(low, fmt_err):
    mm, rnd = low
    g = torch.Generator().manual_seed(3)
    a = torch.randn(8, 16, generator=g, requires_grad=True)
    b = torch.randn(16, 4, generator=g, requires_grad=True)
    y = mm(a, b)
    assert torch.equal(y, rnd(a.detach()) @ rnd(b.detach()))
    y.sum().backward()
    exact = torch.ones(8, 4) @ b.detach().T
    err = float((a.grad - exact).abs().max() / exact.abs().max())
    assert 0 < err <= fmt_err


def test_the_bf16_witness_reads_between_the_program_and_the_control():
    name = "resnet50.train"
    out = {}
    for mode in ("program", "bf16", "control"):
        cell = small_cell(name, mode=mode)
        run = harness.driver(cell).setup(cell)
        run.release()
        out[mode] = run.check()
    for mode, r in out.items():
        assert all(math.isfinite(v) for v in r.values()), (mode, r)
    assert out["bf16"]["grad_gap.median"] < out["control"]["grad_gap.median"]


def _serve(ttft_wait_s):
    cell = small_cell("gpt2m.serve")
    cell.traffic = dict(cell.traffic, ttft_wait_s=ttft_wait_s, rate=200.0)
    run = harness.driver(cell).setup(cell)
    return run, run.window(0.3)


def test_a_serving_backlog_counts_only_errors_as_failed():
    run, w = _serve(0)
    queued = [h for d, h in run.handles if h.ttft_s is None]
    assert queued, "a rate far above the engine's leaves requests queued"
    assert w["failed"] == 0 and w["attempted"] > 0
    assert set(w["metrics"]) == {"serve_tokens_per_s"}
    run.release()


def test_a_serving_mix_that_waits_reports_the_tail():
    run, w = _serve(30)
    assert set(w["metrics"]) == {"serve_tokens_per_s", "ttft_p95_ms"}
    assert w["metrics"]["ttft_p95_ms"] > 0 and w["failed"] == 0
    run.release()
