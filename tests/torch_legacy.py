"""Shared fixtures of the legacy-stack parity tests (the config DSL, the
v2 API and the trainer): one DSL build run through both packages, a
signature of a program for comparing what the two Topologies lower to,
and the run that holds the port's executor against the JAX package's
on the same weights and feeds.

Layer names (`__fc_0__`) and the tmp / parameter names fluid makes come
from per-process counters in each package; `fresh_names()` starts both
packages' counters from zero for one build, so the two programs name
every variable alike and weights pair up by name."""

import contextlib
import importlib

import numpy as np

import paddle_tpu.fluid as JF
import paddle_tpu.fluid.core.program as JP
import paddle_tpu.trainer_config_helpers as JTCH
from paddle_tpu.v2.layer import Layer as JLayer
from paddle_tpu.v2.topology import Topology as JTopology

import paddle_tpu_torch.fluid as TF
import paddle_tpu_torch.fluid.core.program as TP
import paddle_tpu_torch.trainer_config_helpers as TTCH
from paddle_tpu_torch.v2.layer import Layer as TLayer
from paddle_tpu_torch.v2.topology import Topology as TTopology

SIDES = (("jax", JF, JTCH, JTopology), ("torch", TF, TTCH, TTopology))
_COUNTERS = (JLayer._counters, TLayer._counters, JP._unique_counters,
             TP._unique_counters)


@contextlib.contextmanager
def fresh_names():
    """Both packages' layer and fluid name counters from zero inside the
    block; afterwards each counter is at least what it was before, so
    names made later in the process stay unique."""
    saved = [dict(c) for c in _COUNTERS]
    for c in _COUNTERS:
        c.clear()
    try:
        yield
    finally:
        for c, old in zip(_COUNTERS, saved):
            for k, v in old.items():
                c[k] = max(c.get(k, 0), v)


def sub(tch, name):
    """A submodule of the DSL package `tch` (layer_math, networks, ...)."""
    return importlib.import_module(tch.__name__ + "." + name)


def _norm(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in sorted(v.items())}
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if hasattr(v, "ops") and hasattr(v, "idx"):
        return ("block", v.idx)
    if hasattr(v, "name") and isinstance(getattr(v, "name"), str):
        return ("named", v.name)
    return type(v).__name__


def program_sig(prog):
    """Every block's variables (name, shape, dtype, persistable, lod
    level) and ops (type, input and output names, attrs) in order."""
    out = []
    for b in prog.blocks:
        vars_ = [(n, None if v.shape is None else list(v.shape),
                  str(v.dtype), bool(v.persistable),
                  int(getattr(v, "lod_level", 0) or 0))
                 for n, v in b.vars.items()]
        ops = [(op.type,
                {k: list(v) for k, v in sorted(op.inputs.items())},
                {k: list(v) for k, v in sorted(op.outputs.items())},
                _norm(dict(op.attrs)))
               for op in b.ops]
        out.append((b.idx, b.parent_idx, vars_, ops))
    return out


def assert_same_program(jprog, tprog):
    js, ts = program_sig(jprog), program_sig(tprog)
    assert len(js) == len(ts), (len(js), len(ts))
    for jb, tb in zip(js, ts):
        assert jb[:2] == tb[:2]
        assert jb[2] == tb[2], "block %d variables differ" % jb[0]
        assert [o[0] for o in jb[3]] == [o[0] for o in tb[3]], \
            "block %d op types differ" % jb[0]
        for jo, to in zip(jb[3], tb[3]):
            assert jo == to, (jo, to)


def build_both(build, train=None):
    """Run `build(tch)` (returns {key: node}) under each package's DSL
    with fresh counters, and with `train=(key, lr)` minimize node `key`
    with SGD(lr) under the same counters; returns {side: (Topology,
    nodes)}."""
    out = {}
    for side, fluid, tch, topology in SIDES:
        with fresh_names():
            tch.reset_config()
            nodes = build(tch)
            topo = topology(list(nodes.values()))
            if train is not None:
                with fluid.program_guard(topo.main_program,
                                         topo.startup_program):
                    fluid.optimizer.SGD(learning_rate=train[1]).minimize(
                        topo.var_of[nodes[train[0]].name])
            out[side] = (topo, nodes)
    return out


def carry(jscope, tscope):
    """The JAX scope's values into the port's scope on the CPU."""
    TF.scope_from_numpy(tscope, {n: np.asarray(jscope.get(n))
                                 for n in jscope.keys()}, "cpu")


def _compare(j, t, rtol, atol, what):
    j, t = np.asarray(j), np.asarray(t)
    assert j.shape == t.shape, (what, j.shape, t.shape)
    if j.dtype.kind in "iub" or t.dtype.kind in "iub":
        np.testing.assert_array_equal(t, j, err_msg=what)
    else:
        np.testing.assert_allclose(t, j, rtol=rtol, atol=atol, err_msg=what)


def run_both(build, feed, fetch=None, train=None, steps=1, params=None,
             rtol=1e-5, atol=1e-6, extra=()):
    """Build with both DSLs, check the programs are the same, run the
    JAX startup and carry its scope into the port, then run `steps`
    batches of `feed` through both executors and compare every fetch
    (the nodes named by `fetch`, default all, plus the vars named in
    `extra`, e.g. a beam decode's lens) and, after training, every
    persistable. `train=(key, lr)` minimizes node `key` with SGD(lr)
    first. `params` overrides named weights in both scopes."""
    both = build_both(build, train)
    res = {}
    for side, _fluid, _tch, _topo in SIDES:
        topo, nodes = both[side]
        keys = list(fetch or nodes)
        res[side] = (topo, keys, [topo.var_of[nodes[k].name] for k in keys])
    jtopo, keys, jvars = res["jax"]
    ttopo, _, tvars = res["torch"]
    assert_same_program(jtopo.startup_program, ttopo.startup_program)
    assert_same_program(jtopo.main_program, ttopo.main_program)
    jscope, tscope = JF.Scope(), TF.Scope()
    jexe, texe = JF.Executor(JF.CPUPlace()), TF.Executor(TF.CPUPlace())
    with JF.scope_guard(jscope):
        jexe.run(jtopo.startup_program)
    for name, value in (params or {}).items():
        jscope.set(name, np.asarray(value, np.float32))
    carry(jscope, tscope)
    texe._run_counter = jexe._run_counter
    fetches = []
    for step in range(steps):
        jlist = list(jvars) + [e(jvars) for e in extra]
        tlist = list(tvars) + [e(tvars) for e in extra]
        with JF.scope_guard(jscope):
            jout = jexe.run(jtopo.main_program, feed=feed, fetch_list=jlist)
        with TF.scope_guard(tscope):
            tout = texe.run(ttopo.main_program, feed=feed, fetch_list=tlist)
        for i, (j, t) in enumerate(zip(jout, tout)):
            what = "step %d fetch %s" % (
                step, keys[i] if i < len(keys) else "extra %d" % i)
            _compare(j, t, rtol, atol, what)
        fetches.append(tout)
    if train is not None:
        for n in jscope.keys():
            _compare(jscope.get(n), TF.as_numpy(tscope.get(n)), rtol, atol,
                     "param %s" % n)
    return fetches, (jtopo, ttopo), (jscope, tscope)
