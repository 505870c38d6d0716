"""Executor: run a Program with feed/fetch on one device (counterpart of
paddle_tpu/fluid/executor.py; API parity with reference
python/paddle/v2/fluid/executor.py — Executor:166, run:221,
global_scope:27, scope_guard:39, fetch_var:137).

`run` prunes the block to what the fetches and persistables need, then
runs its ops eagerly on the executor's device (core/lowering.py): the
forward region under autograd, one autograd pass for the gradients, the
optimizer ops in place on the scope's tensors. The scope holds its
tensors on the executor's device; feeds that arrive as numpy arrays are
moved there, and fetches come back to the host only when `fetch_list`
names them. Feeds keep their integer width (int64 labels stay int64 for
the gather), where the JAX package narrows int64 to int32; float64 feeds
narrow to float32 as there.

A ragged (LoD) feed is a `(data, [offsets])` pair, or an object with
`.data` and `.lod()` (DataFeeder builds the pairs): `data` packs the
sequences row after row and `offsets` says where each starts. It feeds
`name` and its int32 side-band `name@LOD0`, and the executor keeps a
host copy of the offsets, so the number of sequences and the time
extent of a recurrence come from the host, never from a device read.
A 2-level LoD (`[outer, finest]`, as beam search's init ids come) feeds
its finest level as `name@LOD0` and its outer level as `name@LOD_SRC`,
both with host copies.

A feed that is already a tensor on the executor's device (as
`data_feeder.AsyncDeviceFeeder` delivers them) is used as it is, with
no second copy.

`run(validate=True)` (or PADDLE_TPU_VALIDATE=1, on every run entry
point) verifies the program first (analysis/program_lint.py) and raises
ProgramVerifyError with the JAX package's P-codes, memoized per program
version and feed/fetch signature. PADDLE_TPU_CHECK_NUMERICS=1 (or
FLAGS.check_nan_inf) makes every run check its fetches and the
persistables it wrote for non-finite values (one count per tensor,
summed on the device and read back together) and raise
FloatingPointError naming each. Inside `profiler.profiler()` a run
times each forward op (CUDA events on the card) and the backward with
the update as one row. `run_grad_accum` takes one optimizer step over
micro-batches (core/lowering.py `run_accum`).

On a mesh (`Executor(mesh=...)` or parallel.set_default_mesh; one
process per rank, parallel/mesh.py) a run is SPMD and keeps the JAX
package's global-batch semantics (core/spmd.py has the arithmetic):

- feeds are process-local. A dense feed is this rank's shard of the
  global batch along the mesh's data-parallel axes (every dense feed
  with a leading dim; ranks that share a data coordinate feed the same
  shard), and the ranks of a data group must feed the same local shape;
  a ragged feed is gathered on the host into the exact global packed
  rows and offsets, which every rank then runs whole;
- every op keeps its single-device meaning on the global batch: an op
  that mixes the blocks of a split value (a softmax over the batch,
  `concat` along it, a While over it, ...) reads that value whole,
  gathered, and no op refuses a mesh;
- fetches are global: a per-example value is gathered along the batch in
  rank order, a batch-reduced one is the global value, and a parameter
  with a spec comes back whole;
- the scope holds the consensus values: a parameter with a spec (and its
  optimizer slots) as this rank's shard, everything else whole. A spec
  may split several dimensions (`P("data", "model")`).
  `fetch_var`, `scope_to_numpy` and `io.save_*` read a shard's whole
  value (a collective: every rank calls them together); `scope.get`
  returns the shard itself;
- `run_async_local` is local SGD (parallel/async_sgd.py);
  `run_grad_accum` is refused, as in the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import prng
from . import core
from .core.kernels_control import to_device_async
from .core.kernels_sequence import LOD_SRC, lod_key
from .core.lowering import _backward_slice, run_accum, run_block
from .core.program import Program, Variable
from .core.registry import torch_dtype
from .core.selected_rows import as_dense
from .core.spmd import SpmdContext, gather_split, spec_split

__all__ = ["Executor", "Scope", "global_scope", "scope_guard", "switch_scope",
           "fetch_var", "as_numpy", "scope_from_numpy", "scope_to_numpy"]


def as_numpy(tensor):
    """A fetched value on the host, as an array of its own: the scope's
    tensors are updated in place by later runs. bf16 tensors come back as
    float32 (numpy has no bfloat16)."""
    if isinstance(tensor, (list, tuple)):
        return [as_numpy(t) for t in tensor]
    if isinstance(tensor, torch.Tensor):
        t = tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy().copy() if t.device.type == "cpu" \
            else t.cpu().numpy()
    return np.asarray(tensor)


class _TensorView(object):
    """Minimal stand-in for the reference's LoDTensor handle returned by
    scope.find_var(name).get_tensor()."""

    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get_tensor(self):
        return self

    def __array__(self, dtype=None, copy=None):
        arr = as_numpy(self._scope.full(self._name))
        return arr.astype(dtype) if dtype else arr

    def set(self, value, place=None):
        self._scope.set(self._name, np.asarray(value))

    def shape(self):
        return list(np.asarray(self).shape)


class Scope(object):
    """name -> tensor storage for persistables (params, optimizer state,
    BN running stats). A value set from the host (numpy) moves to the
    executor's device at the next run."""

    def __init__(self):
        self._vars: Dict[str, Any] = {}
        # name -> (mesh, Split) of the values held as this rank's shard
        self._shards: Dict[str, Any] = {}

    def get(self, name):
        return self._vars[name]

    def set(self, name, value):
        self._vars[name] = value
        self._shards.pop(name, None)

    def set_shard(self, name, value, mesh, split):
        """Hold `value` as this rank's block of `name` (split by `split`
        over `mesh`)."""
        self._vars[name] = value
        self._shards[name] = (mesh, split)

    def update(self, name, value):
        """Replace `name`'s value by one of the same layout (a shard stays
        this rank's shard)."""
        self._vars[name] = value

    def full(self, name):
        """The whole value of `name`: a shard is gathered from its ranks
        (a collective, so every rank of its group calls this together)."""
        v = self._vars[name]
        info = self._shards.get(name)
        if info is None:
            return v
        mesh, split = info
        with torch.no_grad():
            return gather_split(v, split, mesh)

    def __contains__(self, name):
        return name in self._vars

    def keys(self):
        return self._vars.keys()

    def drop(self, name):
        self._vars.pop(name, None)
        self._shards.pop(name, None)

    # reference-compatible surface
    def find_var(self, name):
        return _TensorView(self, name) if name in self._vars else None

    def var(self, name):
        self._vars.setdefault(name, None)
        return _TensorView(self, name)


_global_scope = Scope()
_current_scope = _global_scope


def global_scope() -> Scope:
    return _current_scope


def switch_scope(scope: Scope) -> Scope:
    global _current_scope
    prev, _current_scope = _current_scope, scope
    return prev


@contextlib.contextmanager
def scope_guard(scope: Scope):
    prev = switch_scope(scope)
    try:
        yield
    finally:
        switch_scope(prev)


def fetch_var(name, scope: Optional[Scope] = None, return_numpy: bool = True):
    scope = scope or global_scope()
    val = scope.full(name if isinstance(name, str) else name.name)
    return as_numpy(val) if return_numpy else val


def scope_from_numpy(scope: Scope, arrays: Dict[str, Any], device=None):
    """Load a dict of numpy arrays into `scope` as tensors on `device`
    (the card unless the caller names another) — e.g. the JAX package's
    startup weights, so both packages train from the same values."""
    dev = core.place_device(device) if not isinstance(
        device, (str, torch.device)) else torch.device(device)
    for name, arr in arrays.items():
        scope.set(name, _host_to_device(np.asarray(arr), None, dev))
    return scope


def scope_to_numpy(scope: Scope) -> Dict[str, np.ndarray]:
    """Every value of `scope` as a numpy array (bf16 as float32; a shard
    as its whole value)."""
    return {n: as_numpy(scope.full(n)) for n in list(scope.keys())
            if scope.get(n) is not None}


def _feed_name(f):
    return f.name if isinstance(f, Variable) else str(f)


def _want_dtype(var: Optional[Variable], have: str) -> torch.dtype:
    """The dtype a feed or loaded value runs in: the variable's declared
    dtype (float64 narrowed to float32, as the JAX package does; integer
    widths kept), else the value's own with float64 narrowed."""
    name = var.dtype if var is not None and var.dtype is not None else have
    return torch_dtype("float32" if name == "float64" else name)


def _host_to_device(value, var, device):
    if isinstance(value, torch.Tensor):
        t = value
    else:
        arr = np.ascontiguousarray(value)
        # a CPU scope is written in place: never share the caller's array
        if device.type == "cpu" or not arr.flags.writeable:
            arr = arr.copy()
        t = torch.from_numpy(arr)
    want = _want_dtype(var, str(t.dtype).replace("torch.", ""))
    return t.to(device=device, dtype=want)


def _offsets_to_device(host, device):
    """Fed offsets on `device` without a wait on the card (the host
    keeps its own copy): a run whose data is already there waits for
    nothing."""
    return to_device_async(torch.from_numpy(host), device)


def _step_feed(value, i):
    """Step i of a scanned feed: its data's i-th slice, with the offsets
    of a ragged feed unchanged."""
    data, lod = _split_lod_feed(value)
    return data[i] if lod is None else (data[i], lod)


def _split_lod_feed(value):
    """(data, [offsets...] or None) of a feed: a `(data, lod)` pair, an
    object exposing `.data` and `.lod()`, or plain data."""
    if isinstance(value, tuple) and len(value) == 2 \
            and not np.isscalar(value[0]):
        return value[0], _flatten_lod(value[1])
    if hasattr(value, "lod") and hasattr(value, "data"):
        return value.data, _flatten_lod(value.lod())
    return value, None


def _flatten_lod(lod):
    """A fed LoD as a list of levels, each an int32 offsets vector on the
    host, of its own (the reference feeds [[..level0..], [..level1..]])."""
    if lod is None:
        return None

    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.cpu()
        return np.array(v, dtype=np.int32)

    if len(lod) and isinstance(lod[0], (list, tuple, np.ndarray,
                                        torch.Tensor)):
        return [host(lv) for lv in lod]
    return [host(lod)]


class _PlanCache(object):
    """Bounded LRU of run plans (pruned op lists and the persistables a
    run writes) keyed by (program uid, version, fetch names, persistables
    present): the feeds do not change a plan. A plan holds op references
    only, never tensors."""

    def __init__(self, capacity: int = 64):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = capacity
        self._od: "collections.OrderedDict[Any, Any]" = \
            collections.OrderedDict()
        self.hits = self.misses = self.evictions = 0

    def get(self, key):
        entry = self._od.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._od.move_to_end(key)
        self.hits += 1
        return entry

    def __setitem__(self, key, entry):
        self._od[key] = entry
        self._od.move_to_end(key)
        while len(self._od) > self.capacity:
            self._od.popitem(last=False)
            self.evictions += 1

    def clear(self):
        self._od.clear()

    def stats(self) -> Dict[str, int]:
        return {"size": len(self._od), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


class Executor(object):
    """Runs programs on one device: `Executor()` and `CUDAPlace(i)` /
    `TPUPlace(i)` the card (raising where there is none), `CPUPlace()`
    the CPU. With `mesh=` (or a default mesh, parallel.set_default_mesh)
    every run is one rank's part of an SPMD run on the mesh, on the
    mesh's device unless a place names another."""

    def __init__(self, places=None, mesh=None, cache_capacity=None):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        self.place = places
        self.mesh = mesh
        self._device = None
        if places is not None or self._resolve_mesh() is None:
            self._device = core.place_device(places)
        self._cache = _PlanCache(cache_capacity or 64)
        self._run_counter = 0

    @property
    def device(self) -> torch.device:
        if self._device is not None:
            return self._device
        mesh = self._resolve_mesh()
        return mesh.device if mesh is not None else core.place_device(None)

    def _resolve_mesh(self):
        if self.mesh is not None:
            return self.mesh
        from ..parallel.mesh import get_default_mesh

        return get_default_mesh()

    def _maybe_preflight(self, program, feed, fetch_list, force=False):
        """The program verifier's pre-flight, shared by every run entry
        point, so PADDLE_TPU_VALIDATE=1 means what it says whichever
        loop drives the program."""
        if force or os.environ.get(
                "PADDLE_TPU_VALIDATE", "") not in ("", "0"):
            from ..analysis.program_lint import preflight

            preflight(program if program is not None
                      else core.default_main_program(),
                      feeds=list(feed or ()), fetches=fetch_list or ())

    def _next_key(self, program):
        """The run's key on the host: fold_in(PRNGKey(seed), run count)."""
        self._run_counter += 1
        return prng.fold_in(prng.PRNGKey(program.random_seed),
                            self._run_counter)

    # ------------------------------------------------------------------
    def run(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[List[Any]] = None,
        feed_var_name: str = "feed",
        fetch_var_name: str = "fetch",
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
        use_program_cache: bool = True,
        validate: bool = False,
    ):
        """`validate=True` (or PADDLE_TPU_VALIDATE=1) verifies the program
        first: a malformed program (dangling input, dtype clash,
        duplicate parameter, unpaired grad var) raises ProgramVerifyError
        with P-coded findings before any op runs. Memoized per (program
        version, feed/fetch signature)."""
        self._maybe_preflight(program, feed, fetch_list, force=validate)
        program = program if program is not None \
            else core.default_main_program()
        key = to_device_async(self._next_key(program), self.device)
        return self._execute(program, feed or {}, fetch_list or [],
                             scope or global_scope(), return_numpy,
                             use_program_cache, key)

    def run_repeated(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[List[Any]] = None,
        steps: int = 1,
        scan_feeds: bool = False,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """Run `steps` training iterations with one call. With
        scan_feeds=True every feed carries a leading [steps] dim of
        per-step batches (a ragged feed's offsets are shared by every
        step); otherwise the same feed is reused each step. Fetches
        return stacked [steps, ...]. Step i draws from fold_in(run key,
        i), the JAX package's lax.scan schedule."""
        self._maybe_preflight(program, feed, fetch_list)
        program = program if program is not None \
            else core.default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        base = self._next_key(program)
        per_step = []
        for i in range(int(steps)):
            f = {n: _step_feed(v, i) for n, v in feed.items()} \
                if scan_feeds else feed
            per_step.append(self._execute(
                program, f, fetch_list or [], scope, False, True,
                to_device_async(prng.fold_in(base, i), self.device)))
        out = [torch.stack([s[j] for s in per_step])
               for j in range(len(fetch_list or []))]
        return as_numpy(out) if return_numpy else out

    def run_grad_accum(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[List[Any]] = None,
        micro_batches: int = 2,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """ONE optimizer step over `micro_batches` forward/backward
        passes (gradient accumulation): every feed splits into equal
        chunks along axis 0, the mean of the chunk gradients is
        accumulated, and the update applies once; the activations of
        one chunk at a time are alive (core/lowering.py run_accum).

        Exactness caveat: chunk gradients are AVERAGED, which matches
        the full-batch step only for mean-reduced losses (a warning
        fires when the loss comes from a batch-axis sum). Refused, as in
        the JAX package: a mesh, program.amp, program.remat, ragged
        (LoD) feeds, micro_batches < 1."""
        self._maybe_preflight(program, feed, fetch_list)
        if self._resolve_mesh() is not None:
            raise NotImplementedError(
                "run_grad_accum is single-chip; compose large batches "
                "on a mesh with the data axis instead")
        program = program if program is not None \
            else core.default_main_program()
        if int(micro_batches) < 1:
            raise ValueError("micro_batches must be >= 1")
        if program.amp or program.remat:
            raise NotImplementedError(
                "gradient accumulation does not compose with program.amp/"
                "remat (as in the JAX package)")
        scope = scope or global_scope()
        block = program.global_block()
        fetch_names = [_feed_name(f) for f in fetch_list or []]
        persist_names = sorted(v.name for v in program.list_vars()
                               if v.persistable)
        feeds = {}
        for name, value in (feed or {}).items():
            data, lod = _split_lod_feed(value)
            if lod is not None:
                raise NotImplementedError(
                    "gradient accumulation with ragged (LoD) feeds is not "
                    "supported (as in the JAX package)")
            var = block.var(name) if block.has_var(name) else None
            feeds[name] = _host_to_device(data, var, self.device)
        env = self._persist_env(block, persist_names, scope, None)
        ops, persist_out, _ = self._plan(program, fetch_names, env,
                                         persist_names, True, None)
        missing = set(persist_out) - set(env)
        if missing:
            raise ValueError(
                "gradient accumulation requires the program to update (not "
                "create) persistables; missing from scope: %r"
                % sorted(missing))
        persist_in = dict(env)
        fetches = run_accum(block, ops, env, feeds, self.device,
                            micro_batches, self._next_key(program),
                            fetch_names)
        return self._finish(scope, env, persist_out, persist_in,
                            fetch_names, fetches, return_numpy, None)

    def run_async_local(
        self,
        program: Optional[Program] = None,
        feed: Optional[Dict[str, Any]] = None,
        fetch_list: Optional[List[Any]] = None,
        steps: int = 1,
        sync_every: int = 1,
        scope: Optional[Scope] = None,
        return_numpy: bool = True,
    ):
        """AsyncSGD as local SGD (reference ParameterServer2.h:127, go/
        pserver SendGrad; parallel/async_sgd.py has the argument): every
        rank of the mesh's 'data' axis is a replica that trains its own
        parameters and optimizer state for `sync_every` steps with no
        traffic between ranks, then the replicas average their models.
        Feeds are process-local, dense, with a leading [steps] dim and
        then this rank's batch; fetches come back stacked [steps, ...]
        and replica-averaged; the scope ends on the consensus model."""
        self._maybe_preflight(program, feed, fetch_list)
        from ..parallel.async_sgd import run_local_sgd

        program = program if program is not None \
            else core.default_main_program()
        mesh = self._resolve_mesh()
        if mesh is None or "data" not in mesh.axis_names:
            raise ValueError(
                "run_async_local needs a mesh with a 'data' axis "
                "(Executor(mesh=...) or parallel.set_default_mesh)")
        if program.shardings:
            raise ValueError(
                "run_async_local composes with data parallelism only; "
                "drop the tensor-parallel shard_parameter annotations "
                "(replicas must own complete models): %r"
                % sorted(program.shardings))
        feeds = {}
        for name, value in (feed or {}).items():
            data, lod = _split_lod_feed(value)
            if lod is not None:
                raise NotImplementedError(
                    "run_async_local supports dense feeds only (LoD "
                    "batches change shape per step)")
            feeds[name] = data
        return run_local_sgd(self, program, mesh, feeds,
                             fetch_list or [], int(steps), int(sync_every),
                             scope or global_scope(), return_numpy)

    # ------------------------------------------------------------------
    def _plan(self, program, fetch_names, persist_in, persist_names,
              use_cache, mesh):
        key = (program.uid, program.version, tuple(fetch_names),
               tuple(sorted(persist_in)), id(mesh),
               tuple(sorted((k, tuple(v))
                            for k, v in program.shardings.items())))
        plan = self._cache.get(key) if use_cache else None
        if plan is None:
            ops = _backward_slice(program.global_block(), fetch_names,
                                  set(persist_names))
            produced = set()
            for op in ops:
                produced |= set(op.output_arg_names)
            persist_out = sorted(set(persist_in)
                                 | (produced & set(persist_names)))
            plan = (ops, persist_out, _mesh_specs(program, mesh))
            if use_cache:
                self._cache[key] = plan
        return plan

    def _persist_env(self, block, persist_names, scope, spmd):
        """The persistables the scope holds, on the executor's device (a
        value loaded from the host moves there once; on a mesh, a whole
        value of a variable with a spec becomes this rank's shard)."""
        env: Dict[str, Any] = {}
        for name in persist_names:
            if name not in scope or scope.get(name) is None:
                continue
            v = scope.get(name)
            moved = not (isinstance(v, torch.Tensor)
                         and v.device == self.device)
            if moved:
                var = block.var(name) if block.has_var(name) else None
                v = _host_to_device(v, var, self.device)
            if spmd is not None and name in spmd.specs:
                v = spmd.to_shard(name, v)
                scope.set_shard(name, v, spmd.mesh, spmd.specs[name][0])
            elif moved:
                scope.set(name, v)
            env[name] = v
        return env

    def _execute(self, program, feed, fetch_list, scope, return_numpy,
                 use_cache, rng_key, local=False):
        """One run. `local` runs this rank alone even on a mesh (the
        replicas of run_async_local)."""
        from .profiler import active_hook

        block = program.global_block()
        fetch_names = [_feed_name(f) for f in fetch_list]
        persist_names = sorted(v.name for v in program.list_vars()
                               if v.persistable)
        mesh = None if local else self._resolve_mesh()
        if mesh is not None and mesh.backend == "nccl" \
                and self.device.type != "cuda":
            raise ValueError("an NCCL mesh runs on CUDA devices; the "
                             "executor's device is %s" % self.device)
        present = [n for n in persist_names
                   if n in scope and scope.get(n) is not None]
        ops, persist_out, specs = self._plan(
            program, fetch_names, present, persist_names, use_cache, mesh)
        spmd, whole = None, False
        if mesh is not None:
            spmd = SpmdContext(mesh, specs)
            feed, whole = _global_feeds(spmd, feed)
        env = self._persist_env(block, persist_names, scope, spmd)
        persist_in = dict(env)
        host_lods = {}
        for name, value in feed.items():
            var = block.var(name) if block.has_var(name) else None
            data, lod = _split_lod_feed(value)
            env[name] = _host_to_device(data, var, self.device)
            if lod is not None:
                # rows are described by the FINEST level; a coarser outer
                # level (2-level beam-search feeds) rides `x@LOD_SRC`
                bands = [(lod_key(name), lod[-1])]
                if len(lod) > 1:
                    bands.append((name + LOD_SRC, lod[0]))
                for key, host in bands:
                    host_lods[key] = host
                    env[key] = _offsets_to_device(host, self.device)
            elif spmd is not None and spmd.batch is not None and \
                    not whole and env[name].dim() and env[name].shape[0]:
                spmd.mark(name, spmd.batch)
        timer = active_hook(self.device)
        env = run_block(block, ops, env, self.device, base_key=rng_key,
                        keep=fetch_names, host_lods=host_lods,
                        op_timer=timer, spmd=spmd)
        if timer is not None:
            timer.flush()
        fetches = [env[n] for n in fetch_names]
        if spmd is not None:
            fetches = [_whole(spmd, n, f)
                       for n, f in zip(fetch_names, fetches)]
        return self._finish(scope, env, persist_out, persist_in,
                            fetch_names, fetches, return_numpy, spmd)

    def _finish(self, scope, env, persist_out, persist_in, fetch_names,
                fetches, return_numpy, spmd):
        """The run's tail: persistables written back to the scope (on a
        mesh, each variable with a spec as this rank's shard), the
        numerics guard, the fetches (a sparse gradient as its dense
        equivalent; on the host when return_numpy)."""
        for n in persist_out:
            v = env[n].detach()
            old = persist_in.get(n)
            # an amp forward must not persist bf16 state over f32 values
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            if spmd is not None and n in spmd.specs:
                scope.set_shard(n, spmd.to_shard(n, v), spmd.mesh,
                                spmd.specs[n][0])
            else:
                scope.set(n, v)
        out = []
        for n, f in zip(fetch_names, fetches):
            v = as_dense(f).detach()
            if not return_numpy and n in persist_out:
                v = v.clone()  # the scope's tensor is updated in place
            out.append(v)
        _maybe_check_nan_inf(fetch_names, out,
                             [(n, scope.get(n)) for n in persist_out])
        return as_numpy(out) if return_numpy else out

    def close(self):
        self._cache.clear()

    def cache_stats(self) -> Dict[str, int]:
        """Plan-cache occupancy counters: size/capacity/hits/misses/
        evictions."""
        return self._cache.stats()


def _mesh_specs(program, mesh):
    """{name: (Split, whole shape)} of the program's variables with a
    spec that splits them on `mesh` (an axis of extent 1 splits
    nothing). An optimizer op's state of a parameter's shape takes the
    parameter's spec when it has none (a spec given after minimize()),
    as XLA's propagation places it in the JAX package."""
    if mesh is None:
        return {}
    block = program.global_block()
    specs = dict(program.shardings)
    for op in block.ops:
        param = (op.inputs.get("Param") or [None])[0]
        if param not in specs or not block.has_var(param):
            continue
        shape = tuple(block.var(param).shape)
        for slot, names in list(op.inputs.items()) + list(
                op.outputs.items()):
            for n in names:
                if slot not in ("Grad", "LearningRate") and \
                        n not in specs and block.has_var(n) and \
                        tuple(block.var(n).shape) == shape:
                    specs[n] = specs[param]
    out = {}
    for name, spec in specs.items():
        split = spec_split(spec, mesh)
        if split is None or not block.has_var(name):
            continue
        shape = tuple(int(d) for d in block.var(name).shape)
        for d, axes in split.parts:
            if shape[d] % mesh.extent(axes):
                raise ValueError(
                    "%r: dim %d (%d) does not divide over mesh axes %s (%d "
                    "ranks)" % (name, d, shape[d], axes, mesh.extent(axes)))
        out[name] = (split, shape)
    return out


def _whole(spmd, name, value):
    """A fetched value made global: a split one gathered along its split
    dimension (a per-example value along the batch, in rank order)."""
    split = spmd.split_of(name)
    if split is None and spmd.is_shard(name, value):
        split = spmd.specs[name][0]
    if split is None or not isinstance(value, torch.Tensor):
        return value
    with torch.no_grad():
        return spmd.gather(value.detach(), split)


def _global_feeds(spmd, feed):
    """Process-local feeds checked and assembled for a run on the mesh
    (the JAX package's _globalize_feeds). Returns (feeds, whole): the
    ranks of a data group must feed dense values of one shape (each
    rank's shard of the global batch; a batch that does not divide over
    the group is an error, never a silent replicate). A ragged feed
    becomes the exact global packed rows and offsets, gathered on the
    host in rank order (_globalize_ragged), and then every feed of the
    run is gathered whole (`whole`): every rank runs the global batch,
    which the gradient sync's seed keeps exact."""
    if spmd.batch is None:
        return feed, False
    import torch.distributed as dist

    mesh = spmd.mesh
    axes = spmd.data_axes
    group = mesh.host_group(axes)

    n = mesh.extent(axes)
    local = {}
    for name, value in feed.items():
        data, lod = _split_lod_feed(value)
        if lod is not None:
            local[name] = ("ragged", _host_array(data), lod)
        else:
            local[name] = ("dense", tuple(getattr(data, "shape", ())),
                           None)
    sig = sorted((k, v[0], v[1] if v[0] == "dense" else
                  tuple(len(lv) for lv in v[2])) for k, v in local.items())
    every = [None] * n
    dist.all_gather_object(every, (sig, {k: v for k, v in local.items()
                                         if v[0] == "ragged"}),
                           group=group)
    sigs = [e[0] for e in every]
    if any(s != sigs[0] for s in sigs):
        raise ValueError(
            "feeds differ across the mesh's data-parallel tiers %s: per "
            "rank (name, kind, local shape or sequence count) %s; every "
            "rank feeds an equal shard of the global batch (pad the batch "
            "or drop the remainder on the host)" % (list(axes), sigs))
    ragged = [k for k, v in local.items() if v[0] == "ragged"]
    if not ragged:
        return feed, False
    out = {name: _global_ragged([e[1][name] for e in every])
           for name in ragged}
    dense = {k: _host_array(_split_lod_feed(feed[k])[0])
             for k, v in local.items() if v[0] == "dense"}
    if dense:
        parts = [None] * n
        dist.all_gather_object(parts, dense, group=group)
        for k in dense:
            out[k] = np.concatenate([p[k] for p in parts]) \
                if dense[k].ndim else dense[k]
    return out, True


def _host_array(data):
    if isinstance(data, torch.Tensor):
        return data.detach().cpu().numpy()
    return np.asarray(data)


def _global_ragged(parts):
    """The global ragged feed from every rank's (kind, packed rows,
    levels): rows concatenated in rank order, each level's offsets
    rebased by the rows (or sequences) before it."""
    data = np.concatenate([p[1] for p in parts])
    levels = []
    for lv in range(len(parts[0][2])):
        offs, base = [np.zeros(1, np.int64)], 0
        for p in parts:
            o = np.asarray(p[2][lv], np.int64)
            offs.append(o[1:] + base)
            base += int(o[-1])
        levels.append(np.concatenate(offs).astype(np.int32))
    return (data, levels)


def _maybe_check_nan_inf(fetch_names, fetches, persisted):
    """Opt-in numerics guard: with PADDLE_TPU_CHECK_NUMERICS=1 (or
    FLAGS.check_nan_inf / PADDLE_FLAG_CHECK_NAN_INF) every run checks its
    fetches and the persistables it wrote for NaN/Inf and raises
    FloatingPointError naming each offending value, whether a fetch or a
    persistable, and its count (the JAX package's message; reference
    executor.cc:30,132-140). The non-finite counts are summed on the
    device and read back together, one copy for the whole run."""
    from ..utils import FLAGS

    if not (FLAGS.check_nan_inf or os.environ.get(
            "PADDLE_TPU_CHECK_NUMERICS", "") not in ("", "0")):
        return
    named = [(kind, name, v) for kind, pairs in (
        ("fetch", zip(fetch_names, fetches)), ("persistable", persisted))
        for name, v in pairs
        if isinstance(v, torch.Tensor) and v.is_floating_point()]
    if not named:
        return
    counts = torch.stack([(~torch.isfinite(v)).sum()
                          for _, _, v in named]).cpu().tolist()
    bad = ["%s %r (%d/%d non-finite)" % (kind, name, n, v.numel())
           for (kind, name, v), n in zip(named, counts) if n]
    if bad:
        raise FloatingPointError(
            "check_numerics: non-finite values in %s" % "; ".join(bad))
