"""The port's legacy `paddle train` stack (paddle_tpu_torch.trainer) against
the JAX package's: the six benchmarks/paddle configs lower to the same
programs, the small ones train through both `run_config`s from one set
of weights, and the module-binding, device and refusal rules hold.

Tolerances: per-batch costs rtol 1e-5; final parameters rtol 1e-5 with
atol 1e-6 (the RNN config trains with Adam, which turns an f32 rounding
difference in a near-zero gradient into a step difference of that
order; every value is held at that bound elementwise). The JAX package
is imported inside the tests: the spawned ranks import this module."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from torch_mesh import spawn
from torch_native_build import ensure_jax_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmarks", "paddle")
CONFIGS = {
    "resnet": os.path.join(BENCH, "image", "resnet.py"),
    "alexnet": os.path.join(BENCH, "image", "alexnet.py"),
    "googlenet": os.path.join(BENCH, "image", "googlenet.py"),
    "vgg": os.path.join(BENCH, "image", "vgg.py"),
    "smallnet": os.path.join(BENCH, "image", "smallnet_mnist_cifar.py"),
    "rnn": os.path.join(BENCH, "rnn", "rnn.py"),
}
TINY = {
    "smallnet": {"batch_size": "8", "num_samples": "24"},
    "rnn": {"batch_size": "4", "num_samples": "12", "hidden_size": "8"},
}


def _topologies(path, args=None, minimize=False):
    """Each package's Topology of a config (fresh name counters), with
    the config's optimizer applied when `minimize`."""
    from torch_legacy import SIDES, fresh_names
    import paddle_tpu.trainer as JT
    import paddle_tpu_torch.trainer as TT

    out = {}
    for (side, fluid, _tch, topology), tr in zip(SIDES, (JT, TT)):
        with fresh_names():
            state = tr._exec_config(path, dict(args or {}))
            tr.resolve_config_outputs(state)
            topo = topology(state["outputs"])
            if minimize:
                s = state["settings"]
                with fluid.program_guard(topo.main_program,
                                         topo.startup_program):
                    s["learning_method"].make(s["learning_rate"]).minimize(
                        topo.var_of[state["outputs"][0].name])
        out[side] = topo
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_benchmark_config_lowers_to_the_jax_packages_program(name):
    """Default widths (ResNet-50 at 224, batch 64): op types in order,
    their inputs, outputs and attrs, and every variable's shape and
    dtype, in the startup and the main program, before and after the
    config's optimizer. Build only — nothing runs."""
    from torch_legacy import assert_same_program

    topos = _topologies(CONFIGS[name], minimize=True)
    for prog in ("startup_program", "main_program"):
        assert_same_program(getattr(topos["jax"], prog),
                            getattr(topos["torch"], prog))
    assert [n.name for n in topos["jax"]._data_layers] == \
        [n.name for n in topos["torch"]._data_layers]


def _jax_init(path, args, tmp, fmt):
    """The JAX startup weights of a config, saved by the JAX package as a
    checkpoint directory or a v2 Parameters tar; returns the path."""
    from torch_legacy import fresh_names
    import paddle_tpu.fluid as JF
    import paddle_tpu.trainer as JT
    from paddle_tpu.distributed import save_checkpoint
    from paddle_tpu.v2.parameters import write_tar_param

    with fresh_names():
        state = JT._exec_config(path, dict(args))
        JT.resolve_config_outputs(state)
        topo = JT.Topology(state["outputs"])
    scope = JF.Scope()
    with JF.scope_guard(scope):
        JF.Executor(JF.CPUPlace()).run(topo.startup_program)
    names = sorted(v.name for v in topo.main_program.list_vars()
                   if v.persistable and v.name in scope)
    if fmt == "dir":
        class _Params(object):
            def keys(self):
                return names

            def get(self, n):
                return scope.get(n)

        out = os.path.join(tmp, "init")
        save_checkpoint(_Params(), out, step=0)
        return out
    import tarfile

    out = os.path.join(tmp, "init.tar")
    with open(out, "wb") as f, tarfile.open(fileobj=f, mode="w") as tar:
        for n in names:
            write_tar_param(tar, n, np.asarray(scope.get(n)))
    return out


def _record_costs(monkeypatch, executor_cls, into):
    orig = executor_cls.run

    def run(self, program=None, feed=None, fetch_list=None, *a, **kw):
        out = orig(self, program, feed, fetch_list, *a, **kw)
        if feed and fetch_list and len(fetch_list) == 1:
            into.append(float(np.ravel(np.asarray(out[0]))[0]))
        return out

    monkeypatch.setattr(executor_cls, "run", run)


@pytest.mark.parametrize("name,fmt", [("smallnet", "dir"), ("rnn", "tar")])
def test_small_configs_train_alike_from_one_init(name, fmt, tmp_path,
                                                 monkeypatch):
    """Both run_configs train 3 batches from the JAX startup weights
    (crossing as a JAX checkpoint for smallnet, a JAX Parameters tar for
    the RNN); per-batch costs and every saved value (parameters and
    optimizer state, both saves read by the port's loader) agree."""
    from torch_legacy import fresh_names
    import paddle_tpu.fluid as JF
    import paddle_tpu.trainer as JT
    import paddle_tpu_torch.fluid as TF
    import paddle_tpu_torch.trainer as TT
    from paddle_tpu_torch.distributed import load_checkpoint

    path, args = CONFIGS[name], TINY[name]
    init = _jax_init(path, args, str(tmp_path), fmt)
    costs = {"jax": [], "torch": []}
    _record_costs(monkeypatch, JF.Executor, costs["jax"])
    _record_costs(monkeypatch, TF.Executor, costs["torch"])
    stats = {}
    for side, tr, kw in (("jax", JT, {}), ("torch", TT, {"use_gpu": False})):
        with fresh_names():
            stats[side] = tr.run_config(
                path, job="train", config_args=dict(args),
                init_model_path=init, log_period=100,
                save_dir=str(tmp_path / side), **kw)
    assert stats["jax"]["batches"] == stats["torch"]["batches"] == 3
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-5)
    saved = {}
    for side in ("jax", "torch"):
        saved[side] = TF.Scope()
        load_checkpoint(saved[side], str(tmp_path / side / "pass-00000"))
    assert sorted(saved["jax"].keys()) == sorted(saved["torch"].keys())
    for n in saved["jax"].keys():
        np.testing.assert_allclose(saved["torch"].get(n),
                                   saved["jax"].get(n), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


PROBE = textwrap.dedent("""
    import runpy, sys
    sys.argv = ["paddle_tpu_torch.trainer", "--config=%s", "--job=time",
                "--use_gpu=False", "--log_period=1",
                "--config_args=batch_size=4,num_samples=12,hidden_size=8"]
    runpy.run_module("paddle_tpu_torch.trainer", run_name="__main__")
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "paddle_tpu"))
    print("LOADED", bad)
    print("BOUND", sorted(m for m in sys.modules
                          if m.startswith(("paddle.", "paddle_tpu."))
                          or m == "paddle"))
""")


@pytest.mark.parametrize("name", ["smallnet", "rnn"])
def test_provider_naming_the_jax_package_imports_neither_it_nor_jax(name):
    """The benchmark providers say `from paddle_tpu.trainer.
    PyDataProvider2 import ...`; the port's trainer runs them (through
    its CLI) without importing the JAX package or jax, and leaves no
    borrowed name bound afterwards."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", PROBE % CONFIGS[name]],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert "LOADED []" in lines, res.stdout[-2000:]
    assert "BOUND []" in lines, res.stdout[-2000:]
    assert any(l.startswith("Time: ") and "samples/sec" in l
               for l in lines), res.stdout[-2000:]


ALIAS_CONFIG = textwrap.dedent("""
    from paddle.trainer_config_helpers import *

    settings(batch_size=4, learning_rate=0.1,
             learning_method=MomentumOptimizer())
    x = data_layer(name='x', size=4)
    y = data_layer(name='y', size=2)
    p = fc_layer(input=x, size=2, act=SoftmaxActivation())
    outputs(classification_cost(input=p, label=y))
""")


def test_dsl_alias_is_the_ports_while_its_config_runs(tmp_path):
    """The JAX trainer claims `paddle.trainer_config_helpers` for the
    process; a port run afterwards in the same process still execs the
    config against the port's DSL, and hands the name back."""
    import paddle_tpu.trainer as JT
    import paddle_tpu.trainer_config_helpers as jtch
    import paddle_tpu_torch.trainer as TT
    import paddle_tpu_torch.trainer_config_helpers as ttch
    from paddle_tpu_torch.v2.layer import Layer

    cfg = tmp_path / "alias.py"
    cfg.write_text(ALIAS_CONFIG)
    JT.run_config(str(cfg), num_passes=1, log_period=100)
    assert sys.modules["paddle.trainer_config_helpers"] is jtch
    seen = []
    orig = TT.Topology

    def spy(layers, *a, **kw):
        seen.extend(layers)
        return orig(layers, *a, **kw)

    TT.Topology = spy
    try:
        stats = TT.run_config(str(cfg), num_passes=1, log_period=100,
                              use_gpu=False)
    finally:
        TT.Topology = orig
    assert np.isfinite(stats["cost"])
    assert seen and all(isinstance(n, Layer) for n in seen)
    assert ttch.get_config_state()["outputs"] == seen
    assert sys.modules["paddle.trainer_config_helpers"] is jtch
    assert sys.modules["paddle"].trainer_config_helpers is jtch


SIMPLE = textwrap.dedent("""
    settings(batch_size=8, learning_rate=0.3,
             learning_method=MomentumOptimizer())
    x = data_layer(name='x', size=4)
    y = data_layer(name='y', size=2)
    p = fc_layer(input=x, size=2, act=SoftmaxActivation())
    outputs(classification_cost(input=p, label=y))
""")


def test_run_config_needs_the_card_unless_told_cpu(tmp_path):
    """use_gpu None / True is the card: raises on a machine without one,
    before anything runs, with no fallback to the CPU."""
    import torch

    from paddle_tpu_torch.trainer import main, run_config

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = tmp_path / "cfg.py"
    cfg.write_text(SIMPLE)
    for kw in ({}, {"use_gpu": True}, {"use_gpu": "True"}):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_config(str(cfg), **kw)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--config=%s" % cfg])
    stats = run_config(str(cfg), use_gpu="False", log_period=100)
    assert stats["batches"] == 32


def _write_records(native, path, n=64, seed=0):
    """n pickled (x f32[4], label) instances, seeded."""
    import pickle

    rng = np.random.RandomState(seed)
    with native.RecordWriter(path) as w:
        for _ in range(n):
            x = rng.randn(4).astype(np.float32)
            w.write(pickle.dumps((x, int(x.sum() > 0))))


def test_recordio_trains_alike_from_one_init(tmp_path, monkeypatch):
    """--recordio feeds both trainers from one set of record files (two,
    the second by a glob, written by each package's native writer) from
    the JAX startup weights: 2 passes of 4 batches, per-batch costs
    within rtol 1e-5; the port's run goes through its CLI."""
    from torch_legacy import fresh_names
    import paddle_tpu.fluid as JF
    import paddle_tpu.native as jnative
    import paddle_tpu.trainer as JT
    import paddle_tpu_torch.fluid as TF
    import paddle_tpu_torch.native as tnative
    import paddle_tpu_torch.trainer as TT

    ensure_jax_native()
    cfg = tmp_path / "cfg.py"
    cfg.write_text(SIMPLE.replace("batch_size=8", "batch_size=16"))
    _write_records(jnative, str(tmp_path / "a.rio"), n=32, seed=0)
    _write_records(tnative, str(tmp_path / "b-1.rio"), n=32, seed=1)
    rio = "%s,%s" % (tmp_path / "a.rio", tmp_path / "b-*.rio")
    init = _jax_init(str(cfg), {}, str(tmp_path), "dir")
    costs = {"jax": [], "torch": []}
    _record_costs(monkeypatch, JF.Executor, costs["jax"])
    _record_costs(monkeypatch, TF.Executor, costs["torch"])
    with fresh_names():
        stats = JT.run_config(str(cfg), num_passes=2, log_period=100,
                              recordio=rio.split(","),
                              init_model_path=init)
    with fresh_names():
        TT.main(["--config=%s" % cfg, "--use_gpu=False", "--num_passes=2",
                 "--log_period=100", "--recordio=%s" % rio,
                 "--init_model_path=%s" % init])
    assert stats["batches"] == 8 and len(costs["torch"]) == 8
    np.testing.assert_allclose(costs["torch"], costs["jax"], rtol=1e-5)
    with pytest.raises(ValueError, match="no files match"):
        TT.run_config(str(cfg), use_gpu=False,
                      recordio=[str(tmp_path / "missing-*.rio")])


def test_record_readers_yield_the_jax_readers_records(tmp_path):
    """creator.recordio, pickled_records, record_shard and cloud_reader
    of the port yield what the JAX package's yield on the same files;
    cloud_reader leases them through an in-process coordinator, one pass
    per call."""
    import pickle

    import paddle_tpu.data as jdata
    import paddle_tpu.native as jnative
    from paddle_tpu.v2.reader import creator as jcreator
    from paddle_tpu_torch.v2.reader import creator as tcreator

    ensure_jax_native()
    rios = [str(tmp_path / ("p%d.rio" % k)) for k in range(3)]
    for k, p in enumerate(rios):
        _write_records(jnative, p, n=10, seed=k)
    shard = str(tmp_path / "s.rs")
    jdata.write_shard(shard, [pickle.dumps(("r", i)) for i in range(13)],
                      records_per_chunk=4)

    def same(make, *args, **kw):
        j = list(getattr(jcreator, make)(*args, **kw)())
        t = list(getattr(tcreator, make)(*args, **kw)())
        assert len(t) == len(j) and pickle.dumps(t) == pickle.dumps(j)
        return t

    assert len(same("recordio", rios, buf_size=4)) == 30
    assert len(same("recordio", ",".join(rios))) == 30
    assert len(same("pickled_records", rios)) == 30
    assert same("record_shard", shard)[3] == pickle.dumps(("r", 3))
    assert same("record_shard", [shard], decode_fn=pickle.loads)[12] == \
        ("r", 12)
    want = sorted(pickle.dumps(r) for r in jcreator.pickled_records(rios)())
    reader = tcreator.cloud_reader(rios, timeout_sec=10)
    for _ in range(2):  # each call is one pass of the coordinator
        assert sorted(pickle.dumps(r) for r in reader()) == want


def test_save_per_pass_then_resume_continues_exactly(tmp_path, monkeypatch):
    """save_dir writes pass-NNNNN checkpoints (optimizer state included);
    a run resumed from pass 0 trains pass 1's batches to the same costs
    as the uninterrupted run. Each run names its layers from fresh
    counters, as a new process would."""
    from torch_legacy import fresh_names
    import paddle_tpu_torch.fluid as TF
    from paddle_tpu_torch.trainer import run_config

    cfg = tmp_path / "cfg.py"
    cfg.write_text(SIMPLE)
    save = str(tmp_path / "ckpt")
    costs = []
    _record_costs(monkeypatch, TF.Executor, costs)
    with fresh_names():
        run_config(str(cfg), num_passes=2, save_dir=save, use_gpu=False,
                   log_period=100)
    assert sorted(os.listdir(save)) == ["pass-00000", "pass-00001"]
    full = list(costs)
    del costs[:]
    with fresh_names():
        run_config(str(cfg), num_passes=1, use_gpu=False, log_period=100,
                   init_model_path=os.path.join(save, "pass-00000"))
    assert len(full) == 64 and len(costs) == 32
    np.testing.assert_allclose(costs, full[32:], rtol=1e-6)


def test_checkgrad_job_and_tf32_restored(tmp_path):
    import torch

    from paddle_tpu_torch.trainer import run_config

    cfg = tmp_path / "cfg.py"
    cfg.write_text(SIMPLE)
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    out = run_config(str(cfg), job="checkgrad", use_gpu=False)
    assert out["checkgrad"] and max(out["checkgrad"].values()) < 5e-2
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32) == before


def test_time_job_prints_the_trainers_line(tmp_path, capsys):
    from paddle_tpu_torch.trainer import run_config

    cfg = tmp_path / "cfg.py"
    cfg.write_text(SIMPLE)
    stats = run_config(str(cfg), job="time", use_gpu=False, log_period=2)
    out = capsys.readouterr().out
    line = [l for l in out.splitlines() if l.startswith("Time: ")]
    assert len(line) == 1 and "ms/batch" in line[0]
    assert "samples/sec" in line[0] and stats["ms_per_batch"] > 0
    # every batch's cost is reported; "Time:" leaves out the first
    # min(log_period, 5)
    assert len(stats["costs"]) == stats["batches"] > 2
    assert stats["timed"] == stats["batches"] - 2
    assert stats["costs"][-1] == stats["cost"]


def _two_trainers(rank, world, cfg, init, save):
    """One rank of a trainer_count=2 run (gloo, CPU)."""
    import torch

    from paddle_tpu_torch.trainer import run_config

    costs = []
    import paddle_tpu_torch.fluid as TF

    orig = TF.Executor.run

    def run(self, program=None, feed=None, fetch_list=None, *a, **kw):
        out = orig(self, program, feed, fetch_list, *a, **kw)
        if feed and fetch_list and len(fetch_list) == 1:
            costs.append(float(np.ravel(out[0])[0]))
        return out

    TF.Executor.run = run
    torch.manual_seed(0)
    run_config(cfg, trainer_count=2, use_gpu=False, log_period=100,
               config_args={"batch_size": "8", "num_samples": "32"},
               init_model_path=init, save_dir=save)
    return costs


def test_two_trainers_on_a_mesh_equal_one_on_the_global_batch(tmp_path,
                                                              monkeypatch):
    """trainer_count=2 over a gloo world of two CPU ranks: each rank reads
    half of every batch's instances, and the costs and the saved model
    equal the one-process run on the whole batches."""
    import paddle_tpu_torch.fluid as TF
    from paddle_tpu_torch.distributed import load_checkpoint
    from paddle_tpu_torch.trainer import run_config

    path = CONFIGS["smallnet"]
    init = _jax_init(path, {"batch_size": "8", "num_samples": "32"},
                     str(tmp_path), "dir")
    outs = spawn(_two_trainers, 2, tmp_path, path, init,
                 str(tmp_path / "mesh"))
    assert outs[0] == outs[1] and len(outs[0]) == 4
    from torch_legacy import fresh_names

    costs = []
    _record_costs(monkeypatch, TF.Executor, costs)
    with fresh_names():
        run_config(path, use_gpu=False, log_period=100,
                   config_args={"batch_size": "8", "num_samples": "32"},
                   init_model_path=init, save_dir=str(tmp_path / "one"))
    np.testing.assert_allclose(outs[0], costs, rtol=1e-5)
    a, b = TF.Scope(), TF.Scope()
    load_checkpoint(a, str(tmp_path / "mesh" / "pass-00000"))
    load_checkpoint(b, str(tmp_path / "one" / "pass-00000"))
    assert sorted(a.keys()) == sorted(b.keys())
    for n in a.keys():
        np.testing.assert_allclose(a.get(n), b.get(n), rtol=1e-5,
                                   atol=1e-6, err_msg=n)


ASYNC = textwrap.dedent("""
    settings(batch_size=16, learning_rate=0.1,
             learning_method=MomentumOptimizer(0.9),
             algorithm='async_sgd', async_sync_every=2)
    x = data_layer(name='x', size=16)
    net = fc_layer(input=x, size=32, act=TanhActivation())
    net = fc_layer(input=net, size=4, act=SoftmaxActivation())
    lbl = data_layer(name='label', size=4)
    outputs(cross_entropy(name='loss', input=net, label=lbl))
""")


def test_async_sgd_on_one_device_warns_and_trains_synchronously(tmp_path):
    from paddle_tpu_torch.trainer import run_config

    cfg = tmp_path / "async.py"
    cfg.write_text(ASYNC)
    with pytest.warns(UserWarning, match="async_sgd"):
        stats = run_config(str(cfg), trainer_count=1, use_gpu=False,
                           log_period=100)
    assert stats["batches"] == 16 and np.isfinite(stats["cost"])


def _async_rank(rank, world, cfg):
    """One rank of a trainer_count=2 async_sgd run (local SGD rounds)."""
    import paddle_tpu_torch.fluid as TF
    from paddle_tpu_torch.trainer import run_config

    rounds = []
    orig = TF.Executor.run_async_local

    def counted(self, *a, **kw):
        rounds.append(kw.get("steps"))
        return orig(self, *a, **kw)

    TF.Executor.run_async_local = counted
    stats = run_config(cfg, trainer_count=2, use_gpu=False, num_passes=4,
                       log_period=1000)
    return dict(stats, rounds=rounds)


def test_async_sgd_on_two_ranks_runs_local_sgd_rounds(tmp_path):
    """settings(algorithm='async_sgd') with trainer_count=2: each rank
    reads half of the 256 synthesized instances (batches of 8), and the
    buffered pairs of batches run as run_async_local rounds; the
    replica-averaged cost falls."""
    cfg = tmp_path / "async.py"
    cfg.write_text(ASYNC)
    outs = spawn(_async_rank, 2, tmp_path, str(cfg))
    for st in outs:
        assert st["rounds"] == [2] * (4 * 8)
        assert st["batches"] == 4 * 16
        assert np.isfinite(st["cost"])
        assert st["cost"] < st["first_cost"] * 0.9, st
    assert outs[0]["cost"] == outs[1]["cost"]
