"""Spawning a gloo group of CPU ranks for the port's mesh tests.

`spawn(fn, world, tmp_path, *args)` starts `world` processes (spawn
method, so each imports torch and the port afresh, never jax), joins
them into one gloo group through a `file://` store under `tmp_path`
(no TCP port: tier-1 runs several pytest workers at once), calls
`fn(rank, world, *args)` in each with one CPU thread at a lower
priority (`init=False` leaves the group to `fn`), and returns the
list of what each rank returned (pickled through `tmp_path`). A rank
that raises fails the test with its traceback; a group that outlives
`timeout` is killed and fails it too. `fn` must be a module-level
function of a test module, so the children can import it by name.
`snapshot` / `load_snapshot` carry a JAX scope's arrays into a port
scope by variable position.
"""

import multiprocessing as mp
import os
import pickle
import time
import traceback

import numpy as np


def _entry(fn, rank, world, tmp, args, init):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    # the ranks yield the CPU to the tests that share the machine in a
    # parallel run (the JAX package's eager mesh tests wait on threads)
    os.nice(10)
    try:
        if init:
            dist.init_process_group(
                "gloo", init_method="file://" + os.path.join(tmp, "store"),
                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        with open(os.path.join(tmp, "out_%d.pkl" % rank), "wb") as f:
            pickle.dump(out, f)
        if dist.is_initialized():
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, "err_%d.txt" % rank), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn(fn, world, tmp_path, *args, timeout=240, init=True):
    tmp = str(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args,
                                              init))
             for r in range(world)]
    for p in procs:
        p.start()
    # a rank that fails leaves its peers waiting in a collective: stop
    # the group as soon as one exits with an error
    deadline = time.time() + timeout
    while time.time() < deadline and any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            break
        time.sleep(0.05)
    failed = any(p.exitcode not in (None, 0) for p in procs)
    hung = [] if failed else [r for r, p in enumerate(procs)
                              if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = []
    for r in range(world):
        path = os.path.join(tmp, "err_%d.txt" % r)
        if os.path.exists(path):
            with open(path) as f:
                errors.append("rank %d:\n%s" % (r, f.read()))
    if errors or hung:
        raise AssertionError("mesh group failed (hung ranks %s)\n%s"
                             % (hung, "\n".join(errors)))
    outs = []
    for r in range(world):
        with open(os.path.join(tmp, "out_%d.pkl" % r), "rb") as f:
            outs.append(pickle.load(f))
    return outs


def snapshot(main, get):
    """(position, array) of every persistable `get` knows, by position in
    main's variables: the two packages build the same variables in the
    same order, under names that differ."""
    out = []
    for i, v in enumerate(main.global_block().vars.values()):
        if v.persistable:
            try:
                out.append((i, np.asarray(get(v.name))))
            except KeyError:
                pass
    return out


def load_snapshot(fluid, main, scope, snap):
    """A snapshot's arrays into `scope` under main's names."""
    tv = list(main.global_block().vars.values())
    fluid.scope_from_numpy(scope, {tv[i].name: a for i, a in snap}, "cpu")
