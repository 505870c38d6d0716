"""The harness finds every cell, configuration, traffic mix, driver and
metric reader by the names in BENCHMARK.json, so that adding one is
adding files and entries."""

import copy
import importlib
import os

import pytest

from perfbench.lib import harness


def test_every_cell_resolves_by_name():
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        cell = harness.Cell(w["name"], bench=bench, device="cpu")
        assert cell.config_entry["name"] == w["config"]
        assert os.path.exists(os.path.join(harness.ROOT,
                                           cell.config_entry["file"]))
        assert hasattr(harness.driver(cell), "setup")
        assert cell.end_to_end and cell.per_layer
        assert "setup_s" in {m["name"] for m in cell.end_to_end}
        assert set(cell.limits), "no limits for %s" % w["name"]


def test_every_metric_has_a_reader():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_and_metric_are_found_from_data_alone():
    bench = copy.deepcopy(harness.load_benchmark())
    bench["workloads"].append(dict(bench["workloads"][0], name="new.cell"))
    bench["end_to_end"].append({"name": "new_rate", "unit": "x/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["new.cell"]})
    bench["per_layer"].append({"name": "idle_share.lm_train", "unit": "%",
                               "better": "lower", "source": "device_trace",
                               "layer": "device", "moves": "new_rate"})
    cell = harness.Cell("new.cell", bench=bench, device="cpu")
    assert cell.traffic == harness.Cell(
        bench["workloads"][0]["name"], bench=bench, device="cpu").traffic
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "new_rate"]
    # a metric without `workloads` is read wherever what it moves is
    assert "idle_share.lm_train" in [m["name"] for m in cell.per_layer]


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        harness.Cell("no.such.cell", device="cpu")


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    import sys
    import types

    assert "paddle_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "paddle_tpu_torchish", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_the_harness_and_drivers_load_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import perfbench.run; "
            "from perfbench.lib import harness, trace; "
            "import perfbench.drivers.lm_train, perfbench.drivers.lm_serve, "
            "perfbench.drivers.fluid_image_train; "
            "import paddle_tpu_torch.models.transformer, "
            "paddle_tpu_torch.serving.engine, paddle_tpu_torch.fluid; "
            "print(harness.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_metric_modules_import_nothing_of_jax():
    for name in os.listdir(os.path.join(harness.BENCH, "metrics")):
        if name.endswith(".py"):
            src = open(os.path.join(harness.BENCH, "metrics", name)).read()
            assert "jax" not in src and "import paddle_tpu\n" not in src
    importlib.import_module("perfbench.reference.gpt2")
