"""The device mesh over torch.distributed (counterpart of
paddle_tpu/parallel/mesh.py).

SPMD, one process per rank: a `Mesh` lays the ranks of the world out on
named axes in row-major order, as the JAX package's `make_mesh` /
`make_hybrid_mesh` lay out devices, and holds one process group for
every subset of its axes (the ranks that share every other coordinate).
The axis names are the JAX package's:

  'data'        batch sharding (data parallelism; gradients sum here)
  'model'       tensor parallelism (parameters annotated by
                `shard_parameter`)
  'dcn'/'dcn_*' data parallelism across hosts, laid outermost by
                make_hybrid_mesh ('seq' and 'expert' name axes too)

The executor (fluid/executor.py) runs a program on every rank over that
rank's shard of the global batch; collectives.py supplies the
collectives XLA inserts in the JAX package. A CUDA device takes NCCL and
a CPU takes gloo unless the caller names the backend; a backend that
fails raises, it is never swapped for another.

`DistributedContext.initialize` joins the world: `env://` under torchrun
(RANK / WORLD_SIZE / MASTER_ADDR set), explicit coordinates otherwise,
and no launcher at all for a world of one process. `make_mesh` of one
rank initialises that world of one itself.
"""

from __future__ import annotations

import collections
import itertools
import os
import zlib
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["PartitionSpec", "P", "Mesh", "make_mesh", "make_hybrid_mesh",
           "data_parallel_axes", "set_default_mesh", "get_default_mesh",
           "replicated", "data_sharding", "NamedSharding", "shard_parameter",
           "shard_parameters_fsdp", "DistributedContext", "spans_processes"]


class PartitionSpec(tuple):
    """Per-dimension placement of a tensor on a mesh: each entry is None
    (the dimension is whole on every rank), an axis name, or a tuple of
    axis names (the dimension splits over their product, the first
    outermost). The port's stand-in for jax.sharding.PartitionSpec;
    programs save and load it (fluid/core/serialization.py)."""

    def __new__(cls, *entries):
        return tuple.__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec%s" % (tuple.__repr__(self),)


P = PartitionSpec

_default_mesh = None


class NamedSharding(object):
    """A placement descriptor: a mesh and a PartitionSpec (what
    `replicated` and `data_sharding` return)."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __eq__(self, other):
        return isinstance(other, NamedSharding) and \
            other.mesh is self.mesh and other.spec == self.spec

    def __hash__(self):
        return hash((id(self.mesh), self.spec))

    def __repr__(self):
        return "NamedSharding(%r, %r)" % (self.mesh.axis_names, self.spec)


class Mesh(object):
    """Ranks of the world on named axes. `devices` is the numpy array of
    global ranks in the mesh's shape (the JAX Mesh's name for it);
    `shape` maps each axis to its extent; `rank`, `coords` and `device`
    describe this process; `sync_stats` counts the gradient syncs run
    on it. `group(axes)` is the process group of the
    ranks that share this rank's coordinates on every other axis, in
    row-major order of `axes` (None where that group is this rank
    alone)."""

    def __init__(self, ranks: np.ndarray, names: Sequence[str], device,
                 backend: str):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(names)
        self.shape = collections.OrderedDict(
            (n, int(s)) for n, s in zip(self.axis_names, self.devices.shape))
        self.size = int(self.devices.size)
        self.device = torch.device(device)
        self.backend = backend
        self.rank = dist.get_rank()
        where = np.argwhere(self.devices == self.rank)
        if not len(where):
            raise ValueError("rank %d is not in the mesh %s" % (
                self.rank, self.devices.tolist()))
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in where[0])))
        self._groups: Dict[tuple, object] = {}
        self._host_groups: Dict[tuple, object] = {}
        self._build_groups()
        from .collectives import SyncStats

        # the executor's gradient syncs on this mesh
        self.sync_stats = SyncStats()

    # every rank of the world calls new_group for every group, in one
    # order: torch requires it of a group's non-members too
    def _build_groups(self):
        world = dist.get_world_size()
        host = self.backend != "gloo" and world > 1
        for r in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, r):
                for members in self._partition(axes):
                    mine = self.rank in members
                    if len(members) == world:
                        g = dist.group.WORLD
                        hg = _host_world() if host else g
                    elif len(members) == 1:
                        g = hg = None
                    else:
                        g = dist.new_group(members)
                        hg = dist.new_group(members, backend="gloo") \
                            if host else g
                    if mine:
                        self._groups[axes] = g
                        self._host_groups[axes] = hg

    def _partition(self, axes):
        """The rank lists of the groups over `axes`: one per coordinate
        of the other axes, each in row-major order of `axes`."""
        idx = [self.axis_names.index(a) for a in axes]
        rest = [i for i in range(len(self.axis_names)) if i not in idx]
        moved = np.transpose(self.devices, rest + idx)
        flat = moved.reshape(-1, int(np.prod([self.devices.shape[i]
                                              for i in idx])))
        return [[int(r) for r in row] for row in flat]

    def _key(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        unknown = [a for a in axes if a not in self.axis_names]
        if unknown:
            raise ValueError("axes %r are not in the mesh %r"
                             % (unknown, self.axis_names))
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes):
        key = self._key(axes)
        return self._groups[key] if key else None

    def host_group(self, axes):
        """The gloo twin of `group(axes)`, for host-side metadata."""
        key = self._key(axes)
        return self._host_groups[key] if key else None

    def extent(self, axes) -> int:
        return int(np.prod([self.shape[a] for a in self._key(axes)]))

    def index(self, axes) -> int:
        """This rank's row-major position along `axes`."""
        i = 0
        for a in self._key(axes):
            i = i * self.shape[a] + self.coords[a]
        return i

    def __repr__(self):
        return "Mesh(%s, backend=%r, device=%s)" % (
            ", ".join("%s=%d" % kv for kv in self.shape.items()),
            self.backend, self.device)


def _default_device(device):
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to build a mesh of CPU ranks")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _world(n: int, device, backend):
    """Join (or check) the world a mesh of `n` ranks needs."""
    if not dist.is_initialized():
        if n > 1:
            raise ValueError(
                "mesh needs %d devices but only 1 available: start one "
                "process per rank and call DistributedContext.initialize "
                "(torchrun, or explicit coordinates)" % n)
        DistributedContext.initialize(device=device, backend=backend)
    world = dist.get_world_size()
    if n > world:
        raise ValueError("mesh needs %d devices but only %d available"
                         % (n, world))
    return world


def _finish(ranks, names, device):
    if dist.get_rank() not in set(int(r) for r in np.asarray(ranks).flat):
        raise ValueError("rank %d is outside a mesh of ranks %s"
                         % (dist.get_rank(), np.asarray(ranks).tolist()))
    dev = _default_device(device)
    backend = dist.get_backend()
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL world needs CUDA devices, got %s" % dev)
    return Mesh(ranks, names, dev, backend)


def make_mesh(axes: Union[int, Dict[str, int], None] = None,
              devices: Optional[Sequence[int]] = None, device=None,
              backend: Optional[str] = None) -> Mesh:
    """Build a Mesh of ranks. `axes` may be None (every rank on one
    'data' axis), an int N (N ranks on 'data') or a dict such as
    {'data': 4, 'model': 2} (row-major: the last axis varies fastest).
    `devices` lists the global ranks to use (default: the first ranks of
    the world); `device` is this rank's torch device (default: the card
    of its local rank); `backend` names the backend when this call
    starts a world of one process (default: NCCL for a CUDA device,
    gloo for the CPU)."""
    want = None if axes is None else (
        {"data": int(axes)} if isinstance(axes, int) else dict(axes))
    n = int(np.prod(list(want.values()))) if want else 1
    world = _world(n if want else 1, device, backend)
    ranks = list(devices) if devices is not None else list(range(world))
    if want is None:
        want = {"data": len(ranks)}
        n = len(ranks)
    if n > len(ranks):
        raise ValueError("mesh needs %d devices but only %d available"
                         % (n, len(ranks)))
    names = tuple(want)
    arr = np.asarray(ranks[:n]).reshape(tuple(int(want[k]) for k in names))
    return _finish(arr, names, device)


def make_hybrid_mesh(dcn_axes: Dict[str, int], ici_axes: Dict[str, int],
                     devices: Optional[Sequence[int]] = None, device=None,
                     backend: Optional[str] = None) -> Mesh:
    """Multi-host mesh: `dcn_axes` partition across groups of ranks
    (hosts, joined by the data-center network), `ici_axes` within a group
    (one host's cards). DCN axes are laid outermost, so only they cross a
    host boundary (the JAX package's make_hybrid_mesh). Ranks group into
    hosts in contiguous runs of the ICI extent, which is how torchrun
    numbers the ranks of a multi-node job. The executor shards the batch
    over axes named 'dcn'/'dcn_*' and 'data' (data_parallel_axes)."""
    dcn_names = tuple(dcn_axes)
    ici_names = tuple(ici_axes)
    sizes = tuple(int(dcn_axes[k]) for k in dcn_names) + \
        tuple(int(ici_axes[k]) for k in ici_names)
    n = int(np.prod(sizes))
    if not dist.is_initialized() and n > 1:
        raise ValueError("hybrid mesh needs %d devices but only 1 "
                         "available" % n)
    world = _world(n, device, backend)
    ranks = list(devices) if devices is not None else list(range(world))
    if n > len(ranks):
        raise ValueError("hybrid mesh needs %d devices but only %d "
                         "available" % (n, len(ranks)))
    arr = np.asarray(ranks[:n]).reshape(sizes)
    return _finish(arr, dcn_names + ici_names, device)


def data_parallel_axes(mesh: Mesh):
    """(axes, total) of the mesh's data-parallel tiers: every axis named
    'dcn' or 'dcn_*' plus 'data'. The executor shards batch dims over
    exactly these axes."""
    axes = tuple(a for a in mesh.axis_names
                 if a == "data" or a == "dcn" or str(a).startswith("dcn_"))
    total = int(np.prod([mesh.shape[a] for a in axes])) if axes else 1
    return axes, total


def set_default_mesh(mesh: Optional[Mesh]):
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh() -> Optional[Mesh]:
    return _default_mesh


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def data_sharding(mesh: Mesh, ndim: int, axis: str = "data"
                  ) -> NamedSharding:
    """The leading (batch) dim over the data axis."""
    if axis not in mesh.axis_names:
        return replicated(mesh)
    return NamedSharding(mesh, P(axis, *([None] * (ndim - 1))))


def shard_parameter(var, spec):
    """Annotate a Parameter/Variable with a PartitionSpec (tensor
    parallelism). On a mesh the executor holds the variable as this
    rank's shard (1/n of it), gathers it where an op reads it and
    reduce-scatters its gradient; its optimizer slots inherit the spec
    (fluid/optimizer.py _add_accumulator). A spec may split several
    dimensions (`P("data", "model")`, `P("model", ("dcn", "data"))`)."""
    program = var.block.program
    program.shardings[var.name] = PartitionSpec(*spec)
    return var


def shard_parameters_fsdp(program, mesh: Mesh, axis: str = "data",
                          min_size: int = 1024):
    """ZeRO-3/FSDP-style sharding: every trainable parameter of at least
    `min_size` elements, and through the optimizer-slot inheritance all
    its optimizer state, is sharded over `axis` along its largest
    dimension that the axis divides (ties go to the first). Parameters
    that carry a spec already keep it. Call BEFORE minimize() so the
    slots inherit the specs. Returns the sharded parameters' names."""
    n = int(mesh.shape[axis])
    done = []
    for p in program.global_block().all_parameters():
        if not getattr(p, "trainable", True) or p.name in program.shardings:
            continue
        shape = list(p.shape or [])
        if not shape or int(np.prod(shape)) < min_size:
            continue
        cand = sorted((d for d in range(len(shape)) if shape[d] % n == 0),
                      key=lambda d: -shape[d])
        if not cand:
            continue
        spec = [None] * len(shape)
        spec[cand[0]] = axis
        shard_parameter(p, PartitionSpec(*spec))
        done.append(p.name)
    return done


class DistributedContext(object):
    """Process-level view of the world (replaces the reference's
    trainer_id / num_gradient_servers flags, Flags.cpp:60-65, and its
    PSERVERS / TRAINING_ROLE bootstrap)."""

    _initialized = False

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or get_default_mesh()

    @classmethod
    def initialize(cls, coordinator_address: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_device_ids: Optional[Sequence[int]] = None,
                   backend: Optional[str] = None, device=None):
        """Join the world (idempotent per process). Under torchrun
        (RANK, WORLD_SIZE and MASTER_ADDR in the environment) through
        `env://`; otherwise `coordinator_address` ("host:port", or any
        init_method URL such as "file:///path"), `num_processes` and
        `process_id`; with none of them, a world of this process alone,
        which needs no launcher. `backend` defaults to NCCL when this
        rank's device is CUDA and gloo for the CPU; `local_device_ids`
        picks the card of this process."""
        if cls._initialized or dist.is_initialized():
            cls._initialized = True
            return
        if local_device_ids:
            device = torch.device("cuda", int(list(local_device_ids)[0]))
        env = all(k in os.environ
                  for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"))
        if device is None:
            # the card by default; the CPU only for a gloo world named
            # on a machine without one
            device = "cpu" if backend == "gloo" and \
                not torch.cuda.is_available() else _default_device(None)
        dev = torch.device(device)
        backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if env:
            dist.init_process_group(backend, init_method="env://")
        elif coordinator_address is not None:
            url = coordinator_address if "://" in coordinator_address \
                else "tcp://" + coordinator_address
            dist.init_process_group(backend, init_method=url,
                                    world_size=int(num_processes),
                                    rank=int(process_id))
        elif num_processes in (None, 1):
            dist.init_process_group(backend, store=dist.HashStore(),
                                    world_size=1, rank=0)
        else:
            raise ValueError(
                "a world of %s processes needs coordinator_address and "
                "process_id (or torchrun's environment)" % num_processes)
        cls._initialized = True

    @classmethod
    def shutdown(cls):
        if dist.is_initialized():
            dist.destroy_process_group()
        cls._initialized = False
        set_default_mesh(None)

    @property
    def world_size(self) -> int:
        return dist.get_world_size() if dist.is_initialized() else 1

    @property
    def local_device_count(self) -> int:
        return 1  # one rank per process, one device per rank

    @property
    def process_index(self) -> int:
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def process_count(self) -> int:
        return self.world_size

    def shard_reader(self, reader, verify_every: Optional[int] = None):
        """Wrap a v2-style reader so each process sees its 1/process_count
        slice of the stream (round-robin by instance). Every process must
        enumerate the identical stream; `verify_every=K` checks it: after
        every K yielded items the processes all-gather (yield count, CRC
        of the completed rounds), and once more at the stream's end with
        the full (count, CRC), raising on every process on a mismatch
        instead of hanging (the JAX package's guard)."""
        pidx, pcount = self.process_index, self.process_count

        def _check(count, crc):
            pairs = [None] * pcount
            dist.all_gather_object(pairs, (int(count), int(crc)),
                                   group=_host_world())
            if len(set(pairs)) != 1:
                raise RuntimeError(
                    "shard_reader stream divergence: per-process "
                    "(count, fingerprint) pairs %s differ - every process "
                    "must enumerate the identical reader order (same "
                    "shuffle seed, balanced length)" % [list(p)
                                                        for p in pairs])

        def _sharded():
            crc, i, yielded, round_crc = 0, 0, 0, 0
            for i, item in enumerate(reader(), start=1):
                if verify_every and pcount > 1:
                    if (i - 1) % pcount == 0:
                        round_crc = crc
                    crc = _fingerprint(item, crc)
                if (i - 1) % pcount == pidx:
                    yielded += 1
                    yield item
                    if verify_every and pcount > 1 \
                            and yielded % verify_every == 0:
                        _check(yielded, round_crc)
            if verify_every and pcount > 1:
                _check(i, crc)

        return _sharded


_HOST_WORLD = []


def _host_world():
    """A gloo group over the world for host objects (the world itself
    when its backend is gloo)."""
    if dist.get_backend() == "gloo":
        return None
    if not _HOST_WORLD:
        _HOST_WORLD.append(dist.new_group(backend="gloo"))
    return _HOST_WORLD[0]


def _fingerprint(item, crc: int) -> int:
    """Rolling CRC32 of a reader item (arrays / scalars / nested tuples),
    order-sensitive, for shard_reader's divergence guard."""
    if isinstance(item, (tuple, list)):
        for part in item:
            crc = _fingerprint(part, crc)
        return crc
    a = np.asarray(item)
    crc = zlib.crc32(str(a.dtype).encode() + str(a.shape).encode(), crc)
    return zlib.crc32(np.ascontiguousarray(a).tobytes(), crc)


def spans_processes(mesh: Optional[Mesh]) -> bool:
    """True when the mesh holds ranks other than this process's (the
    executor then assembles global values from process-local feeds)."""
    return mesh is not None and mesh.size > 1
