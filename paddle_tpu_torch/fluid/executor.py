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

Not ported yet (ROADMAP, Queue A): the mesh (`Executor(mesh=...)`),
`run_grad_accum`, `run_async_local`, the profiler hooks, the program
verifier (`validate=True`).
"""

from __future__ import annotations

import collections
import contextlib
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils import prng
from . import core
from .core.kernels_control import to_device_async
from .core.kernels_sequence import LOD_SRC, lod_key
from .core.lowering import _backward_slice, run_block
from .core.program import Program, Variable
from .core.registry import torch_dtype

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
        arr = as_numpy(self._scope.get(self._name))
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

    def get(self, name):
        return self._vars[name]

    def set(self, name, value):
        self._vars[name] = value

    def __contains__(self, name):
        return name in self._vars

    def keys(self):
        return self._vars.keys()

    def drop(self, name):
        self._vars.pop(name, None)

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
    val = scope.get(name if isinstance(name, str) else name.name)
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
    """Every value of `scope` as a numpy array (bf16 as float32)."""
    return {n: as_numpy(scope.get(n)) for n in scope.keys()
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
    the CPU."""

    def __init__(self, places=None, mesh=None, cache_capacity=None):
        if isinstance(places, (list, tuple)):
            places = places[0] if places else None
        if mesh is not None:
            raise NotImplementedError(
                "the mesh executor is not ported yet (ROADMAP Queue A, "
                "Fluid)")
        self.place = places
        self.device = core.place_device(places)
        self._cache = _PlanCache(cache_capacity or 64)
        self._run_counter = 0

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
        if validate:
            raise NotImplementedError(
                "the program verifier is not ported yet (ROADMAP Queue A)")
        self._run_counter += 1
        program = program if program is not None \
            else core.default_main_program()
        key = to_device_async(prng.fold_in(prng.PRNGKey(program.random_seed),
                                      self._run_counter), self.device)
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
        self._run_counter += 1
        program = program if program is not None \
            else core.default_main_program()
        feed = feed or {}
        scope = scope or global_scope()
        base = prng.fold_in(prng.PRNGKey(program.random_seed),
                            self._run_counter)
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

    def run_grad_accum(self, *args, **kwargs):
        raise NotImplementedError(
            "run_grad_accum is not ported yet (ROADMAP Queue A, Fluid)")

    def run_async_local(self, *args, **kwargs):
        raise NotImplementedError(
            "run_async_local needs the mesh executor, not ported yet "
            "(ROADMAP Queue A, Fluid)")

    # ------------------------------------------------------------------
    def _plan(self, program, fetch_names, persist_in, persist_names,
              use_cache):
        key = (program.uid, program.version, tuple(fetch_names),
               tuple(sorted(persist_in)))
        plan = self._cache.get(key) if use_cache else None
        if plan is None:
            ops = _backward_slice(program.global_block(), fetch_names,
                                  set(persist_names))
            produced = set()
            for op in ops:
                produced |= set(op.output_arg_names)
            persist_out = sorted(set(persist_in)
                                 | (produced & set(persist_names)))
            plan = (ops, persist_out)
            if use_cache:
                self._cache[key] = plan
        return plan

    def _execute(self, program, feed, fetch_list, scope, return_numpy,
                 use_cache, rng_key):
        block = program.global_block()
        fetch_names = [_feed_name(f) for f in fetch_list]
        persist_names = sorted(v.name for v in program.list_vars()
                               if v.persistable)
        env: Dict[str, Any] = {}
        for name in persist_names:
            if name not in scope or scope.get(name) is None:
                continue
            v = scope.get(name)
            if not (isinstance(v, torch.Tensor) and v.device == self.device):
                # a value loaded from the host moves to the device once
                var = block.var(name) if block.has_var(name) else None
                v = _host_to_device(v, var, self.device)
                scope.set(name, v)
            env[name] = v
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
        ops, persist_out = self._plan(program, fetch_names, persist_in,
                                      persist_names, use_cache)
        env = run_block(block, ops, env, self.device, base_key=rng_key,
                        keep=fetch_names, host_lods=host_lods)
        for n in persist_out:
            v = env[n].detach()
            old = persist_in.get(n)
            # an amp forward must not persist bf16 state over f32 values
            if old is not None and v.dtype != old.dtype:
                v = v.to(old.dtype)
            scope.set(n, v)
        fetches = []
        for n in fetch_names:
            v = env[n].detach()
            if not return_numpy and n in persist_out:
                v = v.clone()  # the scope's tensor is updated in place
            fetches.append(v)
        return as_numpy(fetches) if return_numpy else fetches

    def close(self):
        self._cache.clear()

    def cache_stats(self) -> Dict[str, int]:
        """Plan-cache occupancy counters: size/capacity/hits/misses/
        evictions."""
        return self._cache.stats()
