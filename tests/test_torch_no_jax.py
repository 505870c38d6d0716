"""The port stands alone: importing every paddle_tpu_torch module pulls in
neither jax nor the JAX package, no source of the port (nor
chip_smoke.py or chip_ab.py) names either in an import, and the mesh
tests' spawned ranks (the `*_worker` functions and what importing their
module loads) use the port alone."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "paddle_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _modules():
    out = []
    for dirpath, dirnames, files in os.walk(PKG):
        dirnames[:] = sorted(d for d in dirnames if not d.startswith("_"))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return out


def test_importing_every_module_leaves_jax_out():
    mods = _modules()
    for name in ("engine", "adapters", "kv_store", "integrity", "fleet",
                 "tenancy", "wire", "frontdoor", "loadgen"):
        assert "paddle_tpu_torch.serving." + name in mods
    for name in ("executor", "core.lowering", "core.kernels_nn", "io",
                 "layers.nn", "optimizer", "core.kernels_sequence",
                 "core.kernels_rnn", "core.kernels_ctc", "nets",
                 "data_feeder", "core.kernels_control",
                 "layers.control_flow", "layers.device",
                 "core.selected_rows", "core.kernels_sampled",
                 "evaluator", "learning_rate_decay", "core.kernels_crf",
                 "core.kernels_detection", "layers.detection",
                 "memory_optimization_transpiler", "profiler", "debugger",
                 "debuger", "net_drawer", "graphviz", "op",
                 "default_scope_funcs", "distribute_transpiler",
                 "distribute_transpiler_simple", "distributed_spliter",
                 "core.spmd"):
        assert "paddle_tpu_torch.fluid." + name in mods
    for name in ("mesh", "collectives", "async_sgd", "embedding",
                 "attention", "moe", "pipeline"):
        assert "paddle_tpu_torch.parallel." + name in mods
    for name in ("analysis", "analysis.program_lint",
                 "analysis.diagnostics", "analysis.protocol_lint",
                 "analysis.sched_explore", "utils.flags", "utils.tree",
                 "analysis.__main__", "analysis.entries",
                 "analysis.lock_lint", "analysis.band_lint",
                 "analysis.trace_lint", "analysis.shard_lint",
                 "utils.logging", "utils.stat", "utils.dump_config",
                 "utils.dump_v2_config", "utils.make_model_diagram",
                 "utils.show_pb", "utils.plotcurve", "utils.image_util",
                 "utils.image_multiproc", "utils.preprocess_util",
                 "utils.preprocess_img", "utils.predefined_net",
                 "utils.torch2paddle"):
        assert "paddle_tpu_torch." + name in mods
    for name in ("resnet", "ocr_crnn", "ctr", "lenet", "vgg", "alexnet",
                 "googlenet", "mobilenet", "ssd"):
        assert "paddle_tpu_torch.models." + name in mods
    for name in ("trainer", "trainer.__main__", "trainer.PyDataProvider2",
                 "trainer.PyDataProviderWrapper", "trainer.recurrent_units",
                 "trainer.config_parser", "trainer.config_parser_extension",
                 "trainer_config_helpers",
                 "trainer_config_helpers.networks",
                 "trainer_config_helpers.evaluators",
                 "trainer_config_helpers.layer_math",
                 "trainer_config_helpers.activations",
                 "trainer_config_helpers.attrs",
                 "trainer_config_helpers.poolings",
                 "trainer_config_helpers.optimizers",
                 "trainer_config_helpers.data_sources",
                 "trainer_config_helpers.default_decorators",
                 "trainer_config_helpers.layers",
                 "trainer_config_helpers.utils",
                 "trainer_config_helpers.config_parser_utils",
                 "v2", "v2.data_type", "v2.event", "v2.minibatch",
                 "v2.reader", "v2.reader.creator", "v2.layer", "v2.topology",
                 "v2.parameters", "v2.trainer", "v2.inference",
                 "v2.optimizer", "v2.activation", "v2.attr", "v2.pooling",
                 "v2.networks", "v2.evaluator", "v2.op", "v2.config_base",
                 "v2.data_feeder", "distributed.checkpoint",
                 "v2.master", "native", "data", "data.record_shard",
                 "data.dataset", "data.loader", "data.metrics",
                 "distributed.coordinator", "distributed.supervisor",
                 "distributed.sentinel", "v2.image", "v2.plot",
                 "v2.dataset", "utils.merge_model"):
        assert "paddle_tpu_torch." + name in mods
    for name in ("common", "mnist", "uci_housing", "cifar", "imdb",
                 "imikolov", "sentiment", "movielens", "conll05", "wmt14",
                 "wmt16", "mq2007", "criteo", "flowers", "voc2012"):
        assert "paddle_tpu_torch.v2.dataset." + name in mods
    code = (
        "import importlib, sys\n"
        "for m in %r: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
        "print(repr(bad))\n" % (mods, FORBIDDEN))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"


def _sources():
    for dirpath, _dirs, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "chip_ab.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, (
                "%s imports %s" % (os.path.relpath(path, ROOT), n))


# the test modules whose functions run in the port's spawned ranks: a
# rank imports the module by name, then runs one of its `*_worker`s
RANK_MODULES = ("torch_mesh", "test_torch_mesh", "test_torch_mesh_fluid",
                "test_torch_mesh_sparse", "test_torch_mesh_global",
                "test_torch_mesh_drills", "test_torch_mesh_eval")


def _imported(node):
    for sub in ast.walk(node):
        if isinstance(sub, ast.Import):
            yield from (a.name for a in sub.names)
        elif isinstance(sub, ast.ImportFrom) and sub.level == 0:
            yield sub.module or ""


@pytest.mark.parametrize("module", RANK_MODULES)
def test_the_ranks_of_the_mesh_tests_import_the_port_alone(module):
    path = os.path.join(ROOT, "tests", module + ".py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    top = [n for n in tree.body if isinstance(n, (ast.Import,
                                                  ast.ImportFrom))]
    workers = [n for n in tree.body if isinstance(n, ast.FunctionDef)
               and n.name.endswith("_worker")]
    assert workers or module == "torch_mesh"
    for node in top + workers:
        for n in _imported(node):
            assert n.split(".")[0] not in FORBIDDEN, (
                "%s: %s imports %s" % (module, getattr(node, "name",
                                                       "the module"), n))
    # what a rank loads when it imports the module by name
    code = ("import sys\nsys.path.insert(0, 'tests')\nimport %s\n"
            "print(repr(sorted(m for m in sys.modules "
            "if m.split('.')[0] in %r)))\n" % (module, FORBIDDEN))
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
