"""AsyncSGD as local SGD (counterpart of paddle_tpu/parallel/async_sgd.py).

The reference's asynchronous data parallelism applies each trainer's
gradient to the shared parameters without waiting for the others (C++
pserver per-block async updates, ParameterServer2.h:127; the Go pserver
per gradient, go/pserver/service.go:285 SendGrad). The trade is
staleness for communication: each replica trains on parameters that miss
the other replicas' updates in flight.

The JAX package expresses the same trade as local SGD (periodic model
averaging), and so does the port: every rank of the mesh's 'data' axis
is a replica that keeps its OWN parameter and optimizer-state copy and
runs `sync_every` optimizer steps alone, with no traffic between ranks,
then the replicas average their models (one all-reduce per round). With
`sync_every=1` and an update that is linear in the gradient (SGD,
momentum) this is the synchronous all-reduce step; a larger `sync_every`
is the asynchronous regime, with staleness bounded by the round.

In the port every rank is a replica process (one per rank), so the JAX
package's single-controller restriction does not apply: feeds are
process-local. Entry point: `Executor.run_async_local`, reached from the
user surface by `DistributeTranspiler.transpile(sync_mode=False)`.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils import prng
from . import collectives

__all__ = ["run_local_sgd"]


def run_local_sgd(exe, program, mesh, feeds: Dict[str, Any], fetch_list,
                  steps: int, sync_every: int, scope, return_numpy=True,
                  axis: str = "data"):
    """Run `steps` local steps of `program` on this replica, averaging
    every float persistable of the program over `axis` after each
    `sync_every` steps. Each feed is [steps, local batch, ...]. Step i
    draws from fold_in(fold_in(run key, replica index), i), the JAX
    package's key schedule. Returns the fetches stacked [steps, ...] and
    averaged over the replicas."""
    from ..fluid.core.kernels_control import to_device_async
    from ..fluid.executor import _feed_name, as_numpy

    if steps % sync_every:
        raise ValueError("steps (%d) must be a multiple of sync_every (%d)"
                         % (steps, sync_every))
    for name, v in feeds.items():
        if not len(getattr(v, "shape", ())) or v.shape[0] != steps:
            raise ValueError("feed %r needs a leading [steps=%d] dim, got "
                             "shape %s" % (name, steps,
                                           tuple(getattr(v, "shape", ()))))
    persist_names = sorted(v.name for v in program.list_vars()
                           if v.persistable)
    present = [n for n in persist_names
               if n in scope and scope.get(n) is not None]
    fetch_names = [_feed_name(f) for f in fetch_list]
    _ops, persist_out, _ = exe._plan(program, fetch_names, present,
                                     persist_names, True, None)
    missing = set(persist_out) - set(present)
    if missing:
        raise ValueError(
            "run_async_local requires the program to update (not create) "
            "persistables; missing from scope: %r" % sorted(missing))
    group = mesh.group(axis)
    replicas = mesh.shape[axis]
    key = prng.fold_in(exe._next_key(program), mesh.index(axis))
    per_step = []
    for i in range(steps):
        step_feed = {n: v[i] for n, v in feeds.items()}
        per_step.append(exe._execute(
            program, step_feed, fetch_list, scope, False, True,
            to_device_async(prng.fold_in(key, i), exe.device), local=True))
        if (i + 1) % sync_every == 0:
            _average(scope, present, group, replicas)
    out = []
    for j in range(len(fetch_names)):
        stacked = torch.stack([s[j] for s in per_step])
        if stacked.is_floating_point():
            stacked = collectives.all_reduce(stacked, group) / replicas
        out.append(stacked)
    return as_numpy(out) if return_numpy else out


def _average(scope, names, group, replicas):
    """The replicas' mean of every float persistable in `names` (integer
    state, such as step counters, is equal on every replica)."""
    with torch.no_grad():
        for n in names:
            v = scope.get(n)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                scope.set(n, collectives.all_reduce(v, group) / replicas)
