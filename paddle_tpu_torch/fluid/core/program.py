"""Program IR: Program / Block / Operator / Variable / Parameter.

A copy of the JAX package's IR (paddle_tpu/fluid/core/program.py), which
re-designs the reference's ProgramDesc object model (reference:
paddle/fluid/framework/framework.proto:34-152 and
python/paddle/v2/fluid/framework.py — Variable:127, Operator:362,
Block:633, Program:830, Parameter:991) as a plain Python object graph.
The executor runs a Block's ops eagerly on its device (core/lowering.py),
so the IR only has to be a faithful, introspectable description of the
computation, not a wire format. `serialization.py` writes the same JSON
as the JAX package, for save/load_inference_model in either direction.
"""

from __future__ import annotations

import contextlib
import itertools
import re
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "Variable",
    "Parameter",
    "Operator",
    "Block",
    "Program",
    "default_main_program",
    "default_startup_program",
    "program_guard",
    "switch_main_program",
    "switch_startup_program",
    "unique_name",
    "grad_var_name",
    "convert_np_dtype",
]

_unique_counters: Dict[str, int] = {}


def unique_name(prefix: str) -> str:
    _unique_counters[prefix] = _unique_counters.get(prefix, 0) + 1
    return "%s_%d" % (prefix, _unique_counters[prefix] - 1)


GRAD_VAR_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_VAR_SUFFIX


_DTYPE_ALIASES = {
    "float32": "float32",
    "float64": "float64",
    "float16": "float16",
    "bfloat16": "bfloat16",
    "int8": "int8",
    "int16": "int16",
    "int32": "int32",
    "int64": "int64",
    "uint8": "uint8",
    "bool": "bool",
}


def convert_np_dtype(dtype) -> str:
    """Normalise any dtype spelling (np.dtype, str, jnp dtype) to a str key."""
    if isinstance(dtype, str):
        if dtype not in _DTYPE_ALIASES:
            raise ValueError("unsupported dtype %r" % (dtype,))
        return dtype
    name = np.dtype(dtype).name
    if name not in _DTYPE_ALIASES:
        raise ValueError("unsupported dtype %r" % (dtype,))
    return name


class Variable(object):
    """A named tensor slot in a Block.

    Mirrors reference fluid.framework.Variable (framework.py:127): shape /
    dtype / lod_level / persistable metadata plus convenience numpy-style
    accessors. `shape` may contain -1 for the batch dimension.
    """

    def __init__(
        self,
        block: "Block",
        name: Optional[str] = None,
        shape: Optional[Sequence[int]] = None,
        dtype: Any = None,
        lod_level: int = 0,
        persistable: bool = False,
        stop_gradient: bool = False,
        initializer: Any = None,
        is_data: bool = False,
        **kwargs,
    ):
        self.block = block
        if name is None:
            name = unique_name("_generated_var")
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_np_dtype(dtype) if dtype is not None else "float32"
        self.lod_level = lod_level
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.op: Optional[Operator] = None  # generating op, set by append_op
        if initializer is not None:
            initializer(self, block)

    # --- operator sugar (reference: layers/math_op_patch.py) -------------
    def _binary(self, other, op):
        from ..layers import math_op_patch

        return math_op_patch.binary(self, other, op)

    def __add__(self, other):
        return self._binary(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._binary(other, "elementwise_sub")

    def __rsub__(self, other):
        from ..layers import math_op_patch

        return math_op_patch.binary(self, other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._binary(other, "elementwise_mul")

    __rmul__ = __mul__

    def __div__(self, other):
        return self._binary(other, "elementwise_div")

    __truediv__ = __div__

    def __lt__(self, other):
        return self._binary(other, "less_than")

    def __le__(self, other):
        return self._binary(other, "less_equal")

    def __gt__(self, other):
        return self._binary(other, "greater_than")

    def __ge__(self, other):
        return self._binary(other, "greater_equal")

    def __repr__(self):
        return "Variable(name=%r, shape=%r, dtype=%s, lod=%d%s)" % (
            self.name,
            self.shape,
            self.dtype,
            self.lod_level,
            ", persistable" if self.persistable else "",
        )

    __str__ = __repr__

    def to_string(self, throw_on_error=False):
        return repr(self)


class Parameter(Variable):
    """A trainable, persistable Variable (reference framework.py:991)."""

    def __init__(self, block, shape, dtype, **kwargs):
        if shape is None or dtype is None:
            raise ValueError("Parameter must have shape and dtype")
        for s in shape:
            if s <= 0:
                raise ValueError("each dimension of Parameter must be > 0")
        kwargs.setdefault("persistable", True)
        super().__init__(block, shape=shape, dtype=dtype, **kwargs)
        self.trainable = kwargs.get("trainable", True)
        self.optimize_attr = kwargs.get("optimize_attr", {"learning_rate": 1.0})
        self.regularizer = kwargs.get("regularizer", None)
        self.gradient_clip_attr = kwargs.get("gradient_clip_attr", None)
        self.do_model_average = kwargs.get("do_model_average", None)
        self.update_hook = kwargs.get("update_hook", None)


class Operator(object):
    """One op node: type, named input/output variable lists, attrs.

    Mirrors reference OpDesc (framework.proto:34) / framework.py:362.
    Inputs/outputs map slot name -> list of variable names (multi-var slots
    are how `sum`, `concat`, `while` etc. take variadic inputs).
    """

    def __init__(
        self,
        block: "Block",
        type: str,
        inputs: Optional[Dict[str, Any]] = None,
        outputs: Optional[Dict[str, Any]] = None,
        attrs: Optional[Dict[str, Any]] = None,
    ):
        self.block = block
        self.type = type
        self.inputs: Dict[str, List[str]] = {}
        self.outputs: Dict[str, List[str]] = {}
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}

        def _names(v):
            if v is None:
                return []
            if isinstance(v, (list, tuple)):
                return [x.name if isinstance(x, Variable) else str(x) for x in v]
            return [v.name if isinstance(v, Variable) else str(v)]

        if inputs:
            for slot, v in inputs.items():
                self.inputs[slot] = _names(v)
        if outputs:
            for slot, v in outputs.items():
                names = _names(v)
                self.outputs[slot] = names
                if isinstance(v, (list, tuple)):
                    for x in v:
                        if isinstance(x, Variable):
                            x.op = self
                elif isinstance(v, Variable):
                    v.op = self

    def input(self, slot: str) -> List[str]:
        return self.inputs.get(slot, [])

    def output(self, slot: str) -> List[str]:
        return self.outputs.get(slot, [])

    @property
    def input_arg_names(self):
        return [n for ns in self.inputs.values() for n in ns]

    @property
    def output_arg_names(self):
        return [n for ns in self.outputs.values() for n in ns]

    def attr(self, name: str):
        return self.attrs[name]

    def has_attr(self, name: str) -> bool:
        return name in self.attrs

    def set_attr(self, name: str, val):
        self.attrs[name] = val
        self.block.program._bump_version()

    def __repr__(self):
        ins = {k: v for k, v in self.inputs.items()}
        outs = {k: v for k, v in self.outputs.items()}
        return "{%s: inputs=%r outputs=%r attrs=%r}" % (self.type, ins, outs, self.attrs)


class Block(object):
    """An ordered op list + var symbol table (reference framework.py:633)."""

    def __init__(self, program: "Program", idx: int, parent_idx: int = -1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars: Dict[str, Variable] = {}
        self.ops: List[Operator] = []

    @property
    def parent_block(self) -> Optional["Block"]:
        if self.parent_idx < 0:
            return None
        return self.program.block(self.parent_idx)

    def create_var(self, **kwargs) -> Variable:
        var = Variable(self, **kwargs)
        self.vars[var.name] = var
        self.program._bump_version()
        return var

    def create_parameter(self, **kwargs) -> Parameter:
        global_block = self.program.global_block()
        param = Parameter(global_block, **kwargs)
        global_block.vars[param.name] = param
        self.program._bump_version()
        return param

    def var(self, name: str) -> Variable:
        v = self._find_var_recursive(name)
        if v is None:
            raise ValueError("variable %r not found in block %d" % (name, self.idx))
        return v

    def has_var(self, name: str) -> bool:
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name: str) -> Optional[Variable]:
        blk: Optional[Block] = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def all_parameters(self) -> List[Parameter]:
        return [v for v in self.vars.values() if isinstance(v, Parameter)]

    def append_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.append(op)
        from . import infer_shape as _infer

        _infer.infer_op_shapes(op, self)
        self.program._bump_version()
        return op

    def prepend_op(self, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(0, op)
        self.program._bump_version()
        return op

    def insert_op(self, index: int, type: str, inputs=None, outputs=None, attrs=None) -> Operator:
        op = Operator(self, type=type, inputs=inputs, outputs=outputs, attrs=attrs)
        self.ops.insert(index, op)
        self.program._bump_version()
        return op

    def remove_op(self, index: int):
        del self.ops[index]
        self.program._bump_version()

    def __repr__(self):
        lines = ["Block(idx=%d, parent=%d)" % (self.idx, self.parent_idx)]
        for v in self.vars.values():
            lines.append("  " + repr(v))
        for op in self.ops:
            lines.append("  " + repr(op))
        return "\n".join(lines)


_program_uid_counter = itertools.count()


class Program(object):
    """A list of Blocks; block 0 is the global block (framework.py:830).

    `version` is bumped on every mutation; the executor uses
    (program.uid, version) as part of its plan-cache key so that
    appending ops after a run correctly invalidates the cached plan.
    `uid` is monotonic across the process — unlike id(), it can never be
    recycled by a later allocation, so a dead Program's cache entries can
    never be replayed for a new one.
    """

    def __init__(self):
        self.uid = next(_program_uid_counter)
        self.blocks: List[Block] = [Block(self, 0)]
        self.current_block_idx = 0
        self.version = 0
        self._seed = 0
        # name -> sharding spec (set by the distributed transpiler / pjit glue)
        self.shardings: Dict[str, Any] = {}
        # mixed precision: forward/backward in bf16, f32 master params
        self.amp = False
        # memory_optimize(): rematerialize the forward region in backward
        self.remat = False

    def _bump_version(self):
        self.version += 1

    # --- blocks ---------------------------------------------------------
    def global_block(self) -> Block:
        return self.blocks[0]

    def block(self, idx: int) -> Block:
        return self.blocks[idx]

    def current_block(self) -> Block:
        return self.blocks[self.current_block_idx]

    def create_block(self, parent_idx: Optional[int] = None) -> Block:
        parent = self.current_block_idx if parent_idx is None else parent_idx
        blk = Block(self, len(self.blocks), parent)
        self.blocks.append(blk)
        self.current_block_idx = blk.idx
        self._bump_version()
        return blk

    def rollback(self):
        self.current_block_idx = self.current_block().parent_idx

    # --- random seed (reference framework.py Program.random_seed) -------
    @property
    def random_seed(self):
        return self._seed

    @random_seed.setter
    def random_seed(self, seed):
        self._seed = int(seed)

    # --- convenience ----------------------------------------------------
    def list_vars(self):
        for blk in self.blocks:
            for v in blk.vars.values():
                yield v

    def clone(self, for_test: bool = False) -> "Program":
        """Deep-copy the program. With for_test=True, ops flip to inference
        behaviour (dropout/batch_norm read `is_test`)."""
        import copy

        p = Program.__new__(Program)
        p.uid = next(_program_uid_counter)
        p.blocks = []
        p.current_block_idx = self.current_block_idx
        p.version = self.version
        p._seed = self._seed
        p.shardings = dict(self.shardings)
        p.amp = self.amp
        p.remat = self.remat
        for blk in self.blocks:
            nb = Block(p, blk.idx, blk.parent_idx)
            for name, v in blk.vars.items():
                nv = copy.copy(v)
                nv.block = nb
                nv.op = None
                nb.vars[name] = nv
            p.blocks.append(nb)
        for blk, nb in zip(self.blocks, p.blocks):
            for op in blk.ops:
                nop = Operator(nb, op.type)
                nop.inputs = {k: list(v) for k, v in op.inputs.items()}
                nop.outputs = {k: list(v) for k, v in op.outputs.items()}
                nop.attrs = copy.deepcopy(
                    {k: v for k, v in op.attrs.items() if not k.startswith("_py_")}
                )
                # non-copyable python attrs (e.g. callables) are shared
                for k, v in op.attrs.items():
                    if k.startswith("_py_"):
                        nop.attrs[k] = v
                if for_test and "is_test" in nop.attrs:
                    nop.attrs["is_test"] = True
                nb.ops.append(nop)
        return p

    def _sub_block_outer_reads(self, op) -> set:
        """Names an op's sub-block (recursively) reads from OUTSIDE it.
        Control-flow ops list most reads explicitly (While builds its
        X list from the sub-block), but a sub-block op may also reference
        an outer name directly — pruning must treat those as inputs too
        (reference prune.cc walks sub-blocks the same way)."""
        idx = op.attrs.get("sub_block")
        if idx is None:
            return set()
        sub = self.block(idx)
        produced, reads = set(), set()
        for sop in sub.ops:
            # order-aware: a name read BEFORE the sub-block produces it is
            # an outer dependency (matches While.block()'s reads list and
            # reference prune.cc)
            reads |= (set(sop.input_arg_names) - produced)
            reads |= (self._sub_block_outer_reads(sop) - produced)
            produced |= set(sop.output_arg_names)
        return reads

    def prune(self, targets) -> "Program":
        """Return a clone containing only ops needed to compute `targets`
        (reference: framework/prune.cc via Program.prune). Dependency
        tracing descends through `sub_block` attrs (while, dynamic_rnn),
        so e.g. a beam-search decoder program prunes correctly."""
        if not isinstance(targets, (list, tuple)):
            targets = [targets]
        target_names = set(
            t.name if isinstance(t, Variable) else str(t) for t in targets
        )
        p = self.clone()
        blk = p.global_block()
        needed = set(target_names)
        kept = []
        for op in reversed(blk.ops):
            if set(op.output_arg_names) & needed or op.type in ("feed",):
                kept.append(op)
                needed |= set(op.input_arg_names)
                needed |= p._sub_block_outer_reads(op)
        blk.ops = list(reversed(kept))
        p._bump_version()
        return p

    def __repr__(self):
        return "\n".join(repr(b) for b in self.blocks)

    to_string = lambda self, throw_on_error=False: repr(self)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


def switch_main_program(program: Program) -> Program:
    global _main_program
    prev, _main_program = _main_program, program
    return prev


def switch_startup_program(program: Program) -> Program:
    global _startup_program
    prev, _startup_program = _startup_program, program
    return prev


@contextlib.contextmanager
def program_guard(main_program: Program, startup_program: Optional[Program] = None):
    prev_main = switch_main_program(main_program)
    prev_startup = None
    if startup_program is not None:
        prev_startup = switch_startup_program(startup_program)
    try:
        yield
    finally:
        switch_main_program(prev_main)
        if prev_startup is not None:
            switch_startup_program(prev_startup)
