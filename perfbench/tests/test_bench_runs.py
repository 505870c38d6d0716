"""Each driver rehearsed end to end on the CPU at a small size, through
the harness's own main: the result line's shape, and `correct` coming
out false with the timed path broken underneath."""

import math

import pytest

from perfbench.lib import harness
from perfbench.tests.small import bench, run_small

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _shape(line, cell_name, trace):
    cell = harness.Cell(cell_name, bench=bench(), device="cpu")
    assert list(line)[-1] == "checks"
    assert [k for k in line if k != "breakdown"] == KEYS
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and math.isfinite(m["value"])
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("name", ["gpt2m.train", "resnet50.train",
                                  "gpt2m.serve"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_small_run_prints_the_result_line(name, trace):
    rc, line, raw = run_small(name, trace=trace)
    assert rc == 0
    assert raw.startswith("{") and raw.endswith("}")
    _shape(line, name, trace)
    assert line["attempted"] > 0 and line["failed"] == 0


def _limits_from_a_sound_run(name):
    """Limits at three times what a sound small run reads, plus 0.05 (a
    serving run's sample of finished requests depends on timing); the
    chip's limits are for the chip's sizes."""
    _, line, _ = run_small(name)
    return {k: 3 * c["value"] + 0.05 for k, c in line["checks"].items()}


@pytest.mark.parametrize("name,fault", [
    ("gpt2m.train", "unchanged"), ("gpt2m.train", "half_batch"),
    ("resnet50.train", "unchanged"), ("resnet50.train", "half_batch"),
    ("gpt2m.serve", "token")])
def test_a_broken_timed_path_is_not_correct(name, fault):
    limits = _limits_from_a_sound_run(name)
    rc, line, _ = run_small(name, limits=limits)
    assert rc == 0 and line["correct"] is True
    rc, line, _ = run_small(name, fault=fault, limits=limits)
    assert rc == 0 and line["correct"] is False


def test_a_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.main(["--workload", "gpt2m.train", "--seed", "1",
                       "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_a_jax_module_loaded_at_the_close_prints_no_result(monkeypatch,
                                                           capsys):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    from perfbench.tests.small import small_cell

    import io
    out = io.StringIO()
    rc = harness.main(["--workload", "gpt2m.train", "--seed", "5",
                       "--seconds", "0.1", "--trace", "0"],
                      cell=small_cell("gpt2m.train"), need_card=False,
                      out=out)
    assert rc != 0 and out.getvalue() == ""
    assert "jaxlib" in capsys.readouterr().err
