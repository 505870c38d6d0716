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
`start(fn, world, tmp_path, *args)` starts the same group without
waiting (`collect` then waits for it, or `kill` ends it). `once(
tmp_path_factory, key, compute)` runs a module's shared group once per
test session, however many pytest workers hold the module's tests. `snapshot` / `load_snapshot`
carry a JAX scope's arrays into a port scope by variable position.
"""

import fcntl
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


def start(fn, world, tmp_path, *args, init=True):
    """The group's processes, started: `fn` reports through files of its
    own (it may never return)."""
    tmp = str(tmp_path)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, world, tmp, args,
                                              init))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs


def kill(procs):
    """SIGKILL every process of a group that is still alive: no goodbye."""
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join()


def spawn(fn, world, tmp_path, *args, timeout=240, init=True):
    return collect(start(fn, world, tmp_path, *args, init=init), tmp_path,
                   timeout)


def collect(procs, tmp_path, timeout=240):
    """What each rank of a started group returned, once all have."""
    tmp = str(tmp_path)
    world = len(procs)
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


def once(tmp_path_factory, key, compute):
    """compute() run once in the session and its result shared: pytest-
    xdist hands a module's tests to several workers, and each would
    start the module's ranks again (the workers share the parent of
    their base temporary directories)."""
    root = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent
    path = os.path.join(str(root), key + ".pkl")
    with open(os.path.join(str(root), key + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        out = compute()
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
        return out


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
