"""Op kernel registry + run context (counterpart of
paddle_tpu/fluid/core/registry.py).

An "op kernel" is a function of torch tensors: the executor calls the
kernels of a block one after another, eagerly, on its device. Kernels
never see the scope: they map named input tensors to named output
tensors.

Kernel signature::

    fn(ctx: LoweringContext,
       ins: Dict[slot, List[Tensor]],
       attrs: Dict[str, Any]) -> Dict[slot, List[Tensor] | Tensor]
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch

from ...utils import prng

__all__ = ["register_op", "get_kernel", "has_kernel", "LoweringContext",
           "registered_ops", "torch_dtype"]

# the IR's dtype names (program.convert_np_dtype) -> torch dtypes. Unlike
# the JAX package, int64 stays int64: feeds and fills keep their width
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of an IR dtype name (or of a torch dtype)."""
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError("unsupported dtype %r" % (name,))


_KERNELS: Dict[str, Callable] = {}
_ALL = object()  # LoweringContext._reads of a sub-block: every name


def register_op(op_type: str):
    def deco(fn):
        if op_type in _KERNELS:
            raise ValueError("op %r registered twice" % op_type)
        _KERNELS[op_type] = fn
        return fn

    return deco


def get_kernel(op_type: str) -> Callable:
    try:
        return _KERNELS[op_type]
    except KeyError:
        # the JAX package's error for an op type it does not register
        raise NotImplementedError(
            "no kernel registered for op type %r in paddle_tpu_torch.fluid "
            "(have %d ops: every op the JAX package registers)"
            % (op_type, len(_KERNELS)))


def has_kernel(op_type: str) -> bool:
    return op_type in _KERNELS


def registered_ops() -> List[str]:
    return sorted(_KERNELS)


class LoweringContext(object):
    """Per-run state shared by kernels: the device, the op being run, the
    environment, LoD offsets and RNG derivation.

    Deterministic RNG: every random op folds a fresh counter into the
    run's base key with the port's threefry (utils/prng.py), exactly as
    the JAX package folds it with jax.random, so a random op of a given
    (program, run) draws the same bits in both packages.

    LoD: a ragged variable `x` carries its int32 offsets under
    `x@LOD0` in the environment, on the device. Offsets the host knows
    (fed ones, and those a kernel derives from static shapes, as
    im2sequence does) also keep a host copy, registered against the
    device tensor (`set_lod`, `host_lod`): kernels take a sequence
    count or a time extent from it, never from a device read.
    """

    def __init__(self, block, base_key, device, is_test: bool = False,
                 seq_maxlen=None):
        self.block = block
        self._base_key = base_key
        self._rng_counter = 0
        self.device = device
        self.is_test = is_test
        # the largest FED sequence length of this run (exact, from the
        # host): the time extent of a recurrence whose offsets the host
        # does not know (kernels_rnn._seq_T). Where it knows them, each
        # input pads to its own longest sequence (the JAX package's
        # per-feed `seq_buckets`)
        self.seq_maxlen = seq_maxlen
        # the op being run and its environment (set by lowering.run_op):
        # optimizer kernels read the op's output names to decide whether
        # to update in place; sequence kernels read and write side-bands
        self.op = None
        self.env: dict = {}
        # True while running the bf16 forward region of an AMP program:
        # deny-listed ops (lowering._AMP_F32_OPS) then compute in f32
        self.amp_region = False
        # [True] once any side-band exists: lowering._share_lod returns
        # at once while it is False. A list, shared with sub-contexts
        self._lod_flag = [False]
        # [True] while a checkpointed forward segment is recomputed in the
        # backward (lowering._run_remat): host side effects (a Print, the
        # While statistics) must not happen twice. Shared with sub-contexts
        self._recompute_flag = [False]
        self._host_lods = {}  # id(device offsets) -> (tensor, ndarray)
        # the ops of the run and the names read after it, for `is_read`
        self.ops = ()
        self.keep = ()
        self._reads = None
        # the names the caller fetches, and (in a sub-block) the names
        # ops after the enclosing control-flow op read: the While
        # early-exit gate (kernels_control.py) must not freeze them
        self.fetch_names = frozenset()
        self.downstream_reads = frozenset()
        # lookup output name -> its gradient leaf's name, for the
        # SelectedRows sparse-gradient path (lowering._find_sparse_sites)
        self.sparse_sites: dict = {}
        # the profiler's per-op timer (fluid/profiler.py), or None
        self.op_timer = None

    @property
    def has_lod(self) -> bool:
        return self._lod_flag[0]

    @has_lod.setter
    def has_lod(self, value):
        self._lod_flag[0] = bool(value)

    @property
    def recomputing(self) -> bool:
        return self._recompute_flag[0]

    @recomputing.setter
    def recomputing(self, value):
        self._recompute_flag[0] = bool(value)

    @property
    def host_names(self) -> frozenset:
        """The loop counters and limits of the program: values the
        executor keeps on the host (kernels_control.host_names)."""
        from .kernels_control import host_names

        return host_names(self.block.program) if self.block is not None \
            else frozenset()

    def sub_context(self, block):
        """A context for a control-flow op's sub-block: a fresh RNG
        counter on the same base key (the JAX package builds a new
        LoweringContext there), the run's device, `is_test`,
        `seq_maxlen`, AMP region, recompute flag and fetches, and the host
        copies of LoD offsets shared both ways. Every output counts as read."""
        sub = LoweringContext(block, self._base_key, self.device,
                              is_test=self.is_test,
                              seq_maxlen=self.seq_maxlen)
        sub.amp_region = self.amp_region
        sub.fetch_names = self.fetch_names
        sub._lod_flag = self._lod_flag
        sub._recompute_flag = self._recompute_flag
        sub._host_lods = self._host_lods
        sub._reads = _ALL
        return sub

    def next_key(self):
        if self._base_key is None:
            raise RuntimeError("this execution was built without an RNG key")
        self._rng_counter += 1
        return prng.fold_in(self._base_key, self._rng_counter)

    def set_lod(self, name, offsets, host=None):
        """Bind `offsets` as variable `name`'s side-band in the current
        environment; `host` is their host copy where it is known."""
        from .kernels_sequence import lod_key

        self.env[lod_key(name)] = offsets
        self.has_lod = True
        if host is not None:
            self.note_host_lod(offsets, host)

    def note_host_lod(self, offsets, host):
        self._host_lods[id(offsets)] = (offsets, host)

    def host_lod(self, offsets):
        """The host copy of a device offsets tensor, or None when only
        the device holds them (offsets computed from data)."""
        entry = self._host_lods.get(id(offsets))
        return entry[1] if entry is not None and entry[0] is offsets \
            else None

    def is_read(self, name) -> bool:
        """Whether an op of this run reads `name` or the caller fetches
        it: lets a kernel skip an output that nothing reads (eager torch
        pays for every value it computes, where XLA drops dead ones)."""
        if self._reads is _ALL:
            return True
        if self._reads is None:
            reads = set(self.keep)
            for op in self.ops:
                reads |= set(op.input_arg_names)
                reads |= self.block.program._sub_block_outer_reads(op)
            self._reads = reads
        return name in self._reads
