"""`paddle train`-style CLI (counterpart of paddle_tpu/trainer; reference
paddle/trainer/TrainerMain.cpp:32 + Trainer.cpp): exec a
trainer_config_helpers config, build the shared lazy layer graph into a
fluid Program, and run the train/time/test/checkgrad job on the port's
Executor.

Usage parity with benchmark/paddle/*/run.sh:

    python -m paddle_tpu_torch.trainer --job=time --config=resnet.py \
        --use_gpu=True --trainer_count=1 --log_period=10 \
        --config_args=batch_size=64,layer_num=50

The job runs on the card unless it is given `use_gpu=False`
(`--use_gpu=False`), and raises where there is no card; it never falls
back to the CPU. `trainer_count=N` under torchrun (N processes) trains
data-parallel on a mesh of N ranks, each rank reading its 1/N of the
provider's instances, so the global batch stays `batch_size`.
`--recordio=a.rio,b*.rio` feeds the job from record files of pickled
instance tuples (the JAX package's format) through the native prefetch
queue instead of the config's provider.

Two names are bound in `sys.modules` only while code of a config runs,
and restored afterwards: `paddle.trainer_config_helpers` (to this
port's DSL) while the config executes, and
`paddle_tpu.trainer.PyDataProvider2` / `paddle.trainer.PyDataProvider2`
(to this port's module) while the provider module executes. A full
dotted name found in `sys.modules` imports without its parents, so the
benchmark providers, which name the JAX package's module, run unchanged
without importing it.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import os
import sys
import time
import types
from typing import Any, Dict, List

import numpy as np
import torch

from .. import fluid
from .. import trainer_config_helpers as tch
from ..fluid import core
from ..v2.topology import Topology
from ..v2.trainer import _convert_feed

__all__ = ["main", "run_config"]


def _parse_config_args(s: str) -> Dict[str, str]:
    out = {}
    for kv in (s or "").split(","):
        if not kv:
            continue
        k, _, v = kv.partition("=")
        out[k.strip()] = v.strip()
    return out


_MISSING = object()


@contextlib.contextmanager
def _bound_modules(bindings: Dict[str, Any]):
    """Bind `sys.modules[name] = module` for each entry (and the module as
    an attribute of its parent package, where that package is loaded or
    was made here) for the duration of the block, then restore exactly
    what was there before. A parent package that does not exist is made
    as an empty stand-in only while the block runs, and only where no
    real package of that name is installed."""
    saved: List[Any] = []
    try:
        for name, mod in bindings.items():
            parent, _, leaf = name.rpartition(".")
            if parent and parent.count(".") == 0 \
                    and parent not in sys.modules \
                    and importlib.util.find_spec(parent) is None:
                saved.append(("module", parent, _MISSING))
                sys.modules[parent] = types.ModuleType(parent)
            saved.append(("module", name, sys.modules.get(name, _MISSING)))
            sys.modules[name] = mod
            pkg = sys.modules.get(parent) if parent else None
            if pkg is not None:
                saved.append(("attr", (pkg, leaf),
                              getattr(pkg, leaf, _MISSING)))
                setattr(pkg, leaf, mod)
        yield
    finally:
        for kind, key, old in reversed(saved):
            if kind == "module":
                if old is _MISSING:
                    sys.modules.pop(key, None)
                else:
                    sys.modules[key] = old
            else:
                pkg, leaf = key
                if old is _MISSING:
                    if hasattr(pkg, leaf):
                        delattr(pkg, leaf)
                else:
                    setattr(pkg, leaf, old)


def _exec_config(path: str, config_args: Dict[str, str]):
    """Exec the config with the DSL star-imported (the reference runs
    configs through config_parser inside an embedded interpreter,
    TrainerConfigHelper.cpp -> PythonUtil). Verbatim reference configs
    open with `from paddle.trainer_config_helpers import *`: that name
    is this port's DSL while the config runs, whatever another package
    bound it to before (the JAX trainer claims it for the process)."""
    tch.reset_config(config_args)
    g: Dict[str, Any] = {"__name__": "__paddle_config__", "__file__": path}
    for name in tch.__all__:
        g[name] = getattr(tch, name)
    sys.path.insert(0, os.path.dirname(os.path.abspath(path)))
    try:
        with open(path) as f:
            code = compile(f.read(), path, "exec")
        with _bound_modules({"paddle.trainer_config_helpers": tch}):
            exec(code, g)
    finally:
        sys.path.pop(0)
    return tch.get_config_state()


def _load_provider(data_sources, config_dir):
    """Import the config's provider module and create its reader. The
    provider runs with the JAX package's and the reference's names of
    PyDataProvider2 bound to this port's module (see the module
    docstring)."""
    from . import PyDataProvider2

    spec = importlib.util.spec_from_file_location(
        data_sources["module"],
        os.path.join(config_dir, data_sources["module"] + ".py"),
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[data_sources["module"]] = mod
    with _bound_modules({
            "paddle_tpu.trainer.PyDataProvider2": PyDataProvider2,
            "paddle.trainer.PyDataProvider2": PyDataProvider2}):
        spec.loader.exec_module(mod)
    create = getattr(mod, data_sources["obj"])
    file_list = []
    tl = data_sources.get("train_list")
    if tl and os.path.exists(tl):
        file_list = [l.strip() for l in open(tl) if l.strip()]
    return create(file_list, **data_sources["args"])


class _SimpleSlot(object):
    def __init__(self, type_, seq_type=0):
        self.type = type_
        self.seq_type = seq_type


def _simple_data_provider(data_nodes, n_samples=256, seed=0):
    """Reader + slots for TrainData(SimpleData(...)) configs (reference
    SimpleDataProvider): one dense slot per dense data layer, small
    random ids for Index (label) layers."""
    import numpy as np

    slots = []
    for node in data_nodes:
        t = node.attrs["type"]
        slots.append(_SimpleSlot(t.type, t.seq_type))

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n_samples):
            vals = []
            for node in data_nodes:
                t = node.attrs["type"]
                if t.type == 3:  # Index
                    vals.append(int(rng.randint(0, max(2, t.dim))))
                else:
                    vals.append(rng.randn(t.dim).astype("float32"))
            yield tuple(vals)

    return reader, slots


def _recordio_provider(paths, data_nodes):
    """Instances from record files through the native C++ prefetch
    queue (reference: the Go master dispatches RecordIO chunks;
    trainer-side records are pickled sample tuples as written by
    v2.dataset.common.convert). Slot order = data-layer declaration
    order, like every legacy provider. Paths may be globs."""
    import glob as _glob

    from ..v2.reader import creator

    if isinstance(paths, str):
        paths = paths.split(",")
    files, missing = [], []
    for p in paths:
        hits = sorted(_glob.glob(p))
        if hits:
            files.extend(hits)
        elif os.path.exists(p):
            files.append(p)
        else:
            missing.append(p)
    if missing:
        raise ValueError(
            "recordio provider: no files match %r" % (missing,)
        )

    slots = []
    for node in data_nodes:
        t = node.attrs["type"]
        slots.append(_SimpleSlot(t.type, t.seq_type))

    # non-tuple samples (single-data-layer configs) pass through
    # unchanged; _batches wraps them — same contract as every reader
    reader = creator.pickled_records(files, buf_size=256)
    return reader, slots


def _batches(reader, slots, data_nodes, batch_size):
    """Group provider instances into feed dicts (py_paddle
    DataProviderConverter's role). Provider slot order == data-layer
    declaration order, the legacy wiring."""
    for node, slot in zip(data_nodes, slots):
        node.attrs["type"].seq_type = slot.seq_type
        node.attrs["type"].type = slot.type
    buf = []
    for instance in reader():
        if not isinstance(instance, tuple):
            instance = (instance,)
        buf.append(instance)
        if len(buf) == batch_size:
            yield _convert_feed(buf, data_nodes, None)
            buf = []
    if buf:
        yield _convert_feed(buf, data_nodes, None)


def check_gradients(topo, cost_var, scope, exe, feed, eps=1e-3,
                    max_params=3, rtol=5e-2):
    """--job=checkgrad parity (reference TrainerMain.cpp:55,
    Trainer::checkGradient Trainer.cpp:303): compare analytic gradients
    (fetched grad vars) against central finite differences on the loss.
    TF32 (cuDNN convolutions use it by default in torch) is off for the
    check and restored after it: its 10-bit mantissa alone would exceed
    the gate at eps 1e-3."""
    backends = (torch.backends.cudnn, torch.backends.cuda.matmul)
    saved = [b.allow_tf32 for b in backends]
    for b in backends:
        b.allow_tf32 = False
    try:
        return _check_gradients(topo, cost_var, scope, exe, feed, eps,
                                max_params, rtol)
    finally:
        for b, v in zip(backends, saved):
            b.allow_tf32 = v


def _check_gradients(topo, cost_var, scope, exe, feed, eps, max_params,
                     rtol):
    from ..fluid.backward import append_backward

    with fluid.program_guard(topo.main_program, topo.startup_program):
        params_grads = append_backward(cost_var)
    # smallest parameters first: cheap to perturb element-wise
    params_grads = sorted(
        params_grads, key=lambda pg: int(np.prod(pg[0].shape))
    )[:max_params]

    results = {}
    with fluid.executor.scope_guard(scope):
        for p, g in params_grads:
            (analytic,) = exe.run(
                topo.main_program, feed=feed, fetch_list=[g.name]
            )
            base = fluid.executor.as_numpy(scope.full(p.name)).copy()
            flat = base.reshape(-1)
            idxs = np.linspace(0, flat.size - 1, min(4, flat.size)).astype(int)
            max_rel = 0.0
            for i in idxs:
                for sign, store in ((+1, "hi"), (-1, "lo")):
                    pert = base.copy().reshape(-1)
                    pert[i] += sign * eps
                    scope.set(p.name, pert.reshape(base.shape))
                    (c,) = exe.run(
                        topo.main_program, feed=feed, fetch_list=[cost_var]
                    )
                    if store == "hi":
                        hi = float(np.ravel(c)[0])
                    else:
                        lo = float(np.ravel(c)[0])
                numeric = (hi - lo) / (2 * eps)
                a = float(np.asarray(analytic).reshape(-1)[i])
                denom = max(abs(a), abs(numeric), 1e-6)
                max_rel = max(max_rel, abs(a - numeric) / denom)
            scope.set(p.name, base)
            results[p.name] = max_rel
            status = "ok" if max_rel < rtol else "FAIL"
            print("checkgrad %-40s max_rel=%.4g  %s" % (p.name, max_rel, status))
    return results


def resolve_config_outputs(state):
    """Resolve a config's output layers in place: legacy
    Outputs("name") forms map to nodes with clear errors (shared by
    run_config and utils/dump_config)."""
    if not state["outputs"] and state.get("output_names"):
        registry = state.get("layers_by_name") or {}
        missing = [n for n in state["output_names"] if n not in registry]
        if missing:
            raise ValueError(
                "Outputs(%r): no layer with that name in the config"
                % missing
            )
        state["outputs"] = [registry[n] for n in state["output_names"]]
    if not state["outputs"]:
        raise ValueError("config did not call outputs(...)")
    return state["outputs"]


def build_topology(config_path, config_args=None):
    """Exec a config and lower its outputs: (the DSL's config state, the
    Topology holding the main and startup programs, the first output's
    variable, which is the cost a trainer minimizes)."""
    state = _exec_config(config_path, dict(config_args or {}))
    resolve_config_outputs(state)
    topo = Topology(state["outputs"])
    return state, topo, topo.var_of[state["outputs"][0].name]


def _write_gen_results(state, ids, lens, feed, config_dir,
                       gen_result_dir):
    """Write decoded id rows as dictionary words (reference
    SequenceTextPrinter: one "<source>\t<word word ...>" line per
    generated sequence). Relative dict paths resolve against the config
    dir and its ancestors; result files land in gen_result_dir when
    given (the reference tree is read-only here)."""
    written = []
    for spec in state.get("seqtext_printers", []):
        dict_path = spec.get("dict_file")
        words = None
        if dict_path:
            for base in (os.getcwd(), config_dir,
                         os.path.dirname(config_dir),
                         os.path.dirname(os.path.dirname(config_dir))):
                cand = os.path.normpath(os.path.join(base, dict_path))
                if os.path.exists(cand):
                    with open(cand) as f:
                        words = [w.strip() for w in f]
                    break
        result_path = spec.get("result_file") or "gen_result.txt"
        if gen_result_dir:
            result_path = os.path.join(
                gen_result_dir, os.path.basename(result_path)
            )
        src_raw = feed.get(spec.get("id_input"))
        src_flat = None if src_raw is None else np.ravel(src_raw)
        # beam decode emits beam_size rows PER SOURCE (source-major), so
        # row r belongs to source r // beam_width
        group = 1
        if src_flat is not None and src_flat.size \
                and ids.shape[0] % src_flat.size == 0:
            group = ids.shape[0] // src_flat.size
        with open(result_path, "w") as f:
            for row in range(ids.shape[0]):
                n = int(lens[row]) if row < len(lens) else ids.shape[1]
                toks = [int(t) for t in ids[row][:n]]
                text = " ".join(
                    words[t] if words and 0 <= t < len(words) else str(t)
                    for t in toks
                )
                si = row // group
                src = (
                    int(src_flat[si])
                    if src_flat is not None and si < src_flat.size
                    else si
                )
                f.write("%d\t%s\n" % (src, text))
        written.append(result_path)
    return written


def run_config(config_path, job="train", config_args=None, trainer_count=1,
               num_passes=1, log_period=10, use_gpu=None, save_dir=None,
               recordio=None, init_model_path=None, saving_period=1,
               gen_result_dir=None, scope=None):
    """Programmatic entry (also used by tests). Returns summary dict.

    `scope`: the fluid Scope to train in (a fresh one by default); the
    caller's scope holds the trained parameters afterwards, on the
    card when the run was.

    `use_gpu`: None or True runs on the card (CUDAPlace(0), or this
    rank's card on a mesh) and raises where there is none; False runs on
    the CPU. `trainer_count > 1` joins the torch.distributed world (as
    torchrun describes it) and trains on a data mesh of
    min(trainer_count, world size) ranks; in one process that is 1 and
    there is no mesh."""
    use_gpu = _flag(use_gpu)
    place = fluid.CPUPlace() if use_gpu is False else fluid.CUDAPlace(0)
    if use_gpu is not False:
        core.place_device(place)  # no card: raise before any work
    state, topo, cost_var = build_topology(config_path, config_args)
    settings = state["settings"]

    mesh = _data_mesh(trainer_count, use_gpu)

    # generation configs (rnn_gen.conf family): the output is decoded
    # sentence ids (the var carries a lens side-band), not a scalar cost
    gen_mode = bool(getattr(cost_var, "lens_name", None))
    with fluid.program_guard(topo.main_program, topo.startup_program):
        method = settings.get("learning_method")
        lr = settings.get("learning_rate", 1e-3)
        opt = (
            method.make(lr)
            if method is not None
            else fluid.optimizer.SGD(learning_rate=lr)
        )
        ma_spec = (settings.get("extra") or {}).get("model_average")
        pruning = None
        if job not in ("test", "checkgrad") and not gen_mode:
            opt.minimize(cost_var)
            # params with a legacy pruning update_hook get their static
            # mask built + re-applied after every update — BEFORE
            # ModelAverage so the EMA accumulates masked values
            pruning = fluid.optimizer.StaticPruning().build(
                topo.main_program, topo.startup_program
            )
            if ma_spec is not None:
                # settings(model_average=ModelAverage(...)): EMA slots
                # train inside the step and persist into every
                # checkpoint (live weights stay the resume state)
                fluid.optimizer.ModelAverage.from_spec(ma_spec).build(
                    topo.main_program
                )

    scope = fluid.executor.Scope() if scope is None else scope
    exe = fluid.Executor(place if mesh is None else None, mesh=mesh)
    with fluid.executor.scope_guard(scope):
        exe.run(topo.startup_program)
    if init_model_path:
        # resume/finetune (reference --init_model_path): a checkpoint
        # directory or a v2 Parameters tar
        if os.path.isdir(init_model_path):
            from ..distributed import load_checkpoint

            load_checkpoint(scope, init_model_path, strict=False)
            if pruning is not None and pruning.masks:
                # masks computed in startup reflected the now-discarded
                # random init; rebuild them from the LOADED weights
                with fluid.executor.scope_guard(scope):
                    pruning.recompute(scope)
        else:
            from ..v2.parameters import Parameters

            with open(init_model_path, "rb") as f:
                loaded = Parameters.from_tar(f)
            for name in loaded.names():
                scope.set(name, loaded.get(name))

    if recordio:
        provider_reader, slots = _recordio_provider(
            recordio, topo._data_layers
        )
    elif state.get("data_sources") is not None:
        provider_reader = _load_provider(
            state["data_sources"], os.path.dirname(os.path.abspath(config_path))
        )
        slots = provider_reader.settings.slots
    else:
        # legacy TrainData(SimpleData(...)) configs: synthesize dense/id
        # batches from the declared data layers (the framework's datasets
        # are hermetic synthetics; SimpleDataProvider parity)
        provider_reader, slots = _simple_data_provider(topo._data_layers)
    batch_size = settings.get("batch_size", 256)
    local_batch = batch_size
    if mesh is not None:
        # each rank reads its 1/N of the instances (round-robin): the
        # global batch stays batch_size
        from ..parallel.mesh import DistributedContext

        provider_reader = DistributedContext(mesh).shard_reader(
            provider_reader)
        n = mesh.shape["data"]
        if batch_size % n:
            raise ValueError(
                "batch_size %d does not split over %d trainers"
                % (batch_size, n))
        local_batch = batch_size // n

    if gen_mode:
        all_ids, all_lens, all_src = [], [], {}
        with fluid.executor.scope_guard(scope):
            for feed in _batches(
                provider_reader, slots, topo._data_layers, local_batch
            ):
                ids, lens = exe.run(
                    topo.main_program, feed=feed,
                    fetch_list=[cost_var, cost_var.lens_name],
                )
                all_ids.append(np.asarray(ids))
                all_lens.append(np.ravel(np.asarray(lens)))
                for k, v in feed.items():
                    all_src.setdefault(k, []).append(
                        np.ravel(np.asarray(v[0] if isinstance(v, tuple)
                                            else v))
                    )
        # pad rows to one width before stacking (last batch may be short)
        width = max(a.shape[1] for a in all_ids)
        ids = np.concatenate([
            np.pad(a, ((0, 0), (0, width - a.shape[1])))
            for a in all_ids
        ])
        lens = np.concatenate(all_lens)
        merged_feed = {k: np.concatenate(v) for k, v in all_src.items()}
        written = _write_gen_results(
            state, ids, lens, merged_feed,
            os.path.dirname(os.path.abspath(config_path)), gen_result_dir,
        )
        return {
            "generated": int(ids.shape[0]),
            "ids": ids, "lens": lens,
            "result_files": written,
        }

    if job == "checkgrad":
        feed = next(
            _batches(provider_reader, slots, topo._data_layers, local_batch)
        )
        results = check_gradients(topo, cost_var, scope, exe, feed)
        worst = max(results.values()) if results else 0.0
        if worst > 5e-2:
            raise AssertionError("gradient check failed: %r" % results)
        return {"checkgrad": results}

    # AsyncSGD (reference TrainerConfig.proto OptimizationConfig.algorithm
    # = 'async_sgd'; legacy settings(algorithm='async_sgd')): on a mesh,
    # run the local-SGD redesign — buffer `async_sync_every` dense
    # batches and execute them as one run_async_local round
    # (parallel/async_sgd.py). Without a mesh (or with ragged feeds) the
    # loop below stays synchronous, which is the documented fallback.
    extra = settings.get("extra") or {}
    async_every = 0
    if extra.get("algorithm") == "async_sgd" and job == "train":
        if mesh is not None:
            async_every = max(int(extra.get("async_sync_every", 1)), 1)
        else:
            import warnings

            warnings.warn(
                "settings(algorithm='async_sgd') needs trainer_count>1 "
                "devices; running synchronously"
            )

    # costs: every trained batch's; timed: how many of them "Time:" averages
    stats = dict(batches=0, cost=None, costs=[], timed=0, ms_per_batch=None,
                 img_per_sec=None)
    times: List[float] = []
    state_box = {"async_every": async_every, "pass_id": 0}

    from ..distributed.fault_injection import FaultInjector

    # fresh injector per run: fault steps count THIS run's batches, not
    # a process-lifetime total
    fault = FaultInjector()

    def _record(costs, dt_per, skip_times=False):
        for cost in costs:
            stats["batches"] += 1
            stats["cost"] = cost
            stats["costs"].append(cost)
            if fault.active:
                # PADDLE_FAULT fixture: injected preemption/crash/stall
                # at this batch boundary (SURVEY 5.3)
                fault.tick()
            if stats["batches"] == 1:
                stats["first_cost"] = cost
            # the first batches include compilation; reference --job=time
            # also skips a warmup via log_period. Async rounds with a
            # fresh step-count signature compile too (skip_times).
            if stats["batches"] > min(log_period, 5) and not skip_times:
                times.append(dt_per)
            if stats["batches"] % log_period == 0:
                # reference Trainer.cpp log format — what
                # utils/plotcurve.py parses
                print(
                    "Pass=%d Batch=%d AvgCost=%.4f"
                    % (state_box["pass_id"], stats["batches"], cost)
                )

    def _run_sync(feed):
        (cost,) = exe.run(
            topo.main_program, feed=feed, fetch_list=[cost_var]
        )
        return [float(np.ravel(cost)[0])]

    def _async_fallback(msg):
        import warnings

        warnings.warn("async_sgd: %s; running synchronously" % msg)
        state_box["async_every"] = 0

    def _run_async_buffer(buf):
        """Stack buffered feeds [K, B, ...] (this rank's local batches)
        and run one local-SGD round. Flags the first run of a step count
        in state_box so its wall time stays out of the throughput stats,
        as the JAX package does for its compile-bearing rounds."""
        seen = state_box.setdefault("async_seen_steps", set())
        state_box["async_cold"] = len(buf) not in seen
        seen.add(len(buf))
        stacked = {
            k: np.stack([f[k] for f in buf]) for k in buf[0]
        }
        losses = exe.run_async_local(
            topo.main_program, feed=stacked, fetch_list=[cost_var],
            steps=len(buf), sync_every=len(buf),
        )[0]
        return [float(v) for v in np.ravel(np.asarray(losses))]

    import contextlib

    eval_avg_ctx = contextlib.nullcontext()
    if job == "test" and ma_spec is not None:
        # evaluate on the averaged weights a checkpoint carries (same
        # apply/restore the v2 tester does)
        _ma = fluid.optimizer.ModelAverage.from_spec(ma_spec).attach(scope)
        if _ma._param_names and _ma._steps_name:
            eval_avg_ctx = _ma.apply(scope=scope)

    from ..fluid.data_feeder import AsyncDeviceFeeder

    def _pass_feeds():
        """One pass's batches; the synchronous path double-buffers
        (reference DataProvider.h:249 DoubleBuffer): a background
        thread decodes + uploads batch k+1 while the device trains on
        batch k. The async-SGD path stacks host batches itself, so it
        reads the provider directly."""
        src = _batches(provider_reader, slots, topo._data_layers,
                       local_batch)
        if state_box["async_every"]:
            return src, None
        # multi-process meshes globalize feeds from host data — keep the
        # prefetch host-side there (decode still overlaps)
        from ..parallel.mesh import spans_processes

        up = not (mesh is not None and spans_processes(mesh))
        feeder = AsyncDeviceFeeder(src, capacity=2, upload=up,
                                   place=exe.place)
        return feeder, feeder

    try:
        with eval_avg_ctx, fluid.executor.scope_guard(scope):
            for pass_id in range(num_passes):
                state_box["pass_id"] = pass_id
                buf = []
                feed_src, _feeder = _pass_feeds()
                state_box["feeder"] = _feeder
                for feed in feed_src:
                    t0 = time.time()
                    if state_box["async_every"] and any(
                        isinstance(v, tuple) for v in feed.values()
                    ):
                        # ragged (LoD) batches change shape per step; the
                        # documented fallback is the synchronous loop
                        for f in buf:
                            tf = time.time()
                            _record(_run_sync(f), time.time() - tf)
                        buf = []
                        _async_fallback("LoD feeds cannot stack across steps")
                        t0 = time.time()
                    if state_box["async_every"]:
                        costs = []
                        if buf and any(
                            np.shape(feed[k]) != np.shape(buf[0][k])
                            for k in feed
                        ):
                            # flush a buffer the new batch can't stack with
                            costs += _run_async_buffer(buf)
                            buf = []
                        buf.append(feed)
                        if len(buf) == state_box["async_every"]:
                            costs += _run_async_buffer(buf)
                            buf = []
                        if not costs:
                            continue
                    else:
                        costs = _run_sync(feed)
                    _record(costs, (time.time() - t0) / len(costs),
                            skip_times=state_box.pop("async_cold", False))
                if buf:
                    t0 = time.time()
                    costs = _run_async_buffer(buf)
                    _record(costs, (time.time() - t0) / len(costs),
                            skip_times=state_box.pop("async_cold", False))
                if save_dir and saving_period and \
                        job not in ("test", "checkgrad") and \
                        (pass_id + 1) % saving_period == 0:
                    from ..distributed import save_checkpoint_async

                    # async: the step loop pauses only for the host
                    # snapshot; CRC + disk + commit run in the background.
                    # One save in flight at a time.
                    prev = state_box.pop("ckpt_handle", None)
                    if prev is not None:
                        prev.result()
                    state_box["ckpt_handle"] = save_checkpoint_async(
                        scope, os.path.join(save_dir, "pass-%05d" % pass_id),
                        step=stats["batches"],
                    )
    finally:
        # a raise mid-pass must not leave the prefetch producer pinning
        # device buffers
        feeder = state_box.pop("feeder", None)
        if feeder is not None:
            feeder.close()
        # the in-flight async checkpoint must commit even when a pass
        # raises (durability parity with the old synchronous save);
        # result() also re-raises any writer error
        pending = state_box.pop("ckpt_handle", None)
        if pending is not None:
            pending.result()
    stats["timed"] = len(times)
    if times:
        stats["ms_per_batch"] = 1000.0 * float(np.mean(times))
        stats["img_per_sec"] = batch_size / float(np.mean(times))
    if job == "time" and times:
        print(
            "Time: %.2f ms/batch (%.1f samples/sec)"
            % (stats["ms_per_batch"], stats["img_per_sec"])
        )
    if save_dir and not (
        saving_period and num_passes % saving_period == 0
        and job not in ("test", "checkgrad")
    ):
        # root-level final save only when the last pass did NOT already
        # land in save_dir/pass-NNNNN (avoids double checkpoint I/O)
        from ..distributed import save_checkpoint

        save_checkpoint(scope, save_dir, step=stats["batches"])
    return stats


def _flag(v):
    """--use_gpu as given on the command line or to run_config: None
    stays None (the card), a bool stays, a string is read as one."""
    if v is None or isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("0", "false", "no", "off"):
        return False
    if s in ("1", "true", "yes", "on"):
        return True
    raise ValueError("use_gpu=%r: expected true or false" % (v,))


def _data_mesh(trainer_count, use_gpu):
    """The data mesh of a `trainer_count > 1` run: the ranks of the
    torch.distributed world (joined here when torchrun describes one),
    at most trainer_count of them; None when that is a single rank."""
    if trainer_count <= 1:
        return None
    import torch.distributed as dist

    from ..parallel.mesh import DistributedContext, make_mesh

    device = "cpu" if use_gpu is False else None
    if not dist.is_initialized() and int(
            os.environ.get("WORLD_SIZE", "1")) > 1:
        DistributedContext.initialize(device=device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = min(int(trainer_count), world)
    if n <= 1:
        return None
    return make_mesh({"data": n}, device=device)


def main(argv=None):
    p = argparse.ArgumentParser(prog="paddle_tpu_torch.trainer")
    p.add_argument("command", nargs="?", default="train")
    p.add_argument("--config", required=True)
    p.add_argument("--job", default="train",
                   choices=["train", "time", "test", "checkgrad"])
    p.add_argument("--config_args", default="")
    p.add_argument("--trainer_count", type=int, default=1)
    p.add_argument("--num_passes", type=int, default=1)
    p.add_argument("--log_period", type=int, default=10)
    p.add_argument("--test_period", type=int, default=0)
    p.add_argument("--use_gpu", default=None)
    p.add_argument("--save_dir", default=None)
    p.add_argument("--init_model_path", default=None,
                   help="checkpoint dir or Parameters tar to start from")
    p.add_argument("--saving_period", type=int, default=1,
                   help="save into save_dir/pass-NNNNN every N passes")
    p.add_argument("--gen_result_dir", default=None,
                   help="redirect generation result files into this "
                        "directory (the config's own paths may be "
                        "read-only)")
    p.add_argument("--recordio", default=None,
                   help="comma-separated recordio files/globs of pickled "
                        "sample tuples (read through the native prefetch "
                        "queue instead of the config's provider)")
    args = p.parse_args(argv)
    run_config(
        args.config,
        job=args.job,
        config_args=_parse_config_args(args.config_args),
        trainer_count=args.trainer_count,
        num_passes=args.num_passes,
        log_period=args.log_period,
        use_gpu=args.use_gpu,
        save_dir=args.save_dir,
        recordio=args.recordio.split(",") if args.recordio else None,
        init_model_path=args.init_model_path,
        saving_period=args.saving_period,
        gen_result_dir=args.gen_result_dir,
    )
