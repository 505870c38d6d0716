"""Program verifier: static validation of a `fluid.core.program.Program`
(the port's own copy of paddle_tpu/analysis/program_lint.py; the checks
and P-codes are the same).

Reference parity: the C++ stack validated every ProgramDesc before the
Executor interpreted it — OpDesc::CheckAttrs + InferShapeContext input/
output existence checks (framework/op_desc.cc, operator.cc:484) made a
malformed graph fail loudly at submit time. A malformed Program
(dangling input, dtype clash, dead write) otherwise surfaces as a
KeyError or a shape error deep inside `Executor.run`. This pass walks the object graph
op-by-op and reports `Diagnostic` records with stable P-codes instead:

  P001 dangling-input       op input never produced by a prior op, a
                            feed (is_data), a fed name, or a persistable
  P002 dead-write           op whose every output is non-persistable,
                            never consumed downstream, and not fetched
  P003 dtype-mismatch       binary elementwise/sum inputs with clashing
                            declared dtypes
  P004 shape-mismatch       same-rank elementwise inputs whose declared
                            shapes cannot broadcast
  P005 duplicate-parameter  one Parameter name defined in >1 block
  P006 unpaired-grad        a @GRAD var whose base var does not exist

Sub-blocks (while / dynamic_rnn) are walked with the availability the
owning op sees, mirroring Program._sub_block_outer_reads' order-aware
contract, plus the names the owning op binds inside them (a
dynamic_rnn's step inputs, static inputs and memories; its step
outputs and memory updates count as read by it). A tensor array exists
from `create_array` on, which makes it with no op. The JAX package's
copy knows neither and reports a valid DynamicRNN program's step
inputs, and the first `array_write` of an array, as P001. The `autodiff` op differentiates the forward region, so it
implicitly *consumes* every value produced before it (dead-write
analysis treats it that way) and legitimately has no declared inputs.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set

from .diagnostics import Diagnostic, ProgramVerifyError, make

__all__ = ["verify_program", "preflight", "ELEMENTWISE_OPS"]

# ops whose value is their side effect (or that manage their own
# dataflow): never reported as dead writes
SIDE_EFFECT_OPS = {
    "print", "autodiff", "while", "dynamic_rnn", "conditional_block",
    "parallel_do", "feed", "fetch", "save", "load", "send", "recv",
    "increment", "beam_search_decode",
}

# binary ops whose two inputs must agree in dtype (and broadcast in shape)
ELEMENTWISE_OPS = {
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_pow", "elementwise_max",
    "elementwise_min",
}

GRAD_SUFFIX = "@GRAD"


def _is_parameter(var) -> bool:
    # duck-typed so corpora can hand-build IR without importing fluid here
    return type(var).__name__ == "Parameter" or getattr(
        var, "trainable", None) is not None


def _find_var(block, name):
    try:
        return block._find_var_recursive(name)
    except AttributeError:
        return None


def verify_program(program, feeds: Iterable[str] = (),
                   fetches: Iterable[str] = (),
                   label: str = "<program>") -> List[Diagnostic]:
    """Validate `program`; returns diagnostics (empty = clean).

    `feeds` are names the caller will feed at run time (beyond is_data
    vars); `fetches` are the run's fetch targets — both extend liveness
    so a verifier pass over a real (program, feed, fetch_list) triple
    has no false positives. With no `fetches`, dead-write analysis
    treats the final op's outputs as the program's result."""
    feeds = set(feeds)
    fetches = set(str(f) if not hasattr(f, "name") else f.name
                  for f in fetches)
    diags: List[Diagnostic] = []

    _check_duplicate_parameters(program, label, diags)
    _check_grad_pairing(program, label, diags)

    top = program.global_block()
    if not fetches and top.ops:
        fetches = set(top.ops[-1].output_arg_names)
    _check_block(program, top, set(), feeds, diags, label)
    _check_dead_writes(program, feeds, fetches, diags, label)
    return diags


# --- P005 --------------------------------------------------------------

def _check_duplicate_parameters(program, label, diags):
    owner = {}
    for blk in program.blocks:
        for name, var in blk.vars.items():
            if not _is_parameter(var):
                continue
            if name in owner and owner[name] is not blk:
                diags.append(make(
                    "P005", label, 0, "block%d" % blk.idx, name,
                    "parameter %r is defined in block %d and block %d"
                    % (name, owner[name].idx, blk.idx)))
            else:
                owner[name] = blk
    return diags


# --- P006 --------------------------------------------------------------

def _check_grad_pairing(program, label, diags):
    names: Set[str] = set()
    for blk in program.blocks:
        names.update(blk.vars)
        for op in blk.ops:
            names.update(op.output_arg_names)
    for blk in program.blocks:
        for name in sorted(blk.vars):
            if GRAD_SUFFIX not in name:
                continue
            base = name[: name.index(GRAD_SUFFIX)]
            if base and base not in names:
                diags.append(make(
                    "P006", label, 0, "block%d" % blk.idx, name,
                    "gradient var %r has no forward var %r"
                    % (name, base)))


# --- P001 / P003 / P004 ------------------------------------------------

def _check_block(program, blk, outer_avail, feeds, diags, label):
    produced = set(outer_avail)
    for op in blk.ops:
        for name in op.input_arg_names:
            if name in produced or name in feeds:
                continue
            var = _find_var(blk, name)
            # a tensor array exists from create_array on (no op makes it):
            # its first array_write reads it empty
            if var is not None and (var.persistable
                                    or getattr(var, "is_data", False)
                                    or getattr(var, "is_tensor_array", False)
                                    or _is_parameter(var)):
                continue
            diags.append(make(
                "P001", label, 0, "block%d" % blk.idx,
                "%s:%s" % (op.type, name),
                "op %r reads %r, which no prior op, feed, or "
                "persistable produces" % (op.type, name)))
        _check_op_types(blk, op, diags, label)
        sub_idx = op.attrs.get("sub_block")
        if isinstance(sub_idx, int) and 0 <= sub_idx < len(program.blocks):
            _check_block(program, program.block(sub_idx),
                         produced | _bound_inside(op), feeds, diags, label)
        produced.update(op.output_arg_names)


def _broadcastable(a, b) -> bool:
    if a is None or b is None or len(a) != len(b):
        return True  # rank mismatch / unknown: paddle's axis-broadcast,
        # not checkable without attr semantics — stay conservative
    for x, y in zip(a, b):
        if -1 in (x, y) or 1 in (x, y) or x == y:
            continue
        return False
    return True


def _check_op_types(blk, op, diags, label):
    if op.type in ELEMENTWISE_OPS:
        xs = op.input("X")
        ys = op.input("Y")
        if not (xs and ys):
            return
        vx, vy = _find_var(blk, xs[0]), _find_var(blk, ys[0])
        if vx is None or vy is None:
            return
        if vx.dtype and vy.dtype and vx.dtype != vy.dtype:
            diags.append(make(
                "P003", label, 0, "block%d" % blk.idx,
                "%s:%s|%s" % (op.type, xs[0], ys[0]),
                "op %r mixes dtypes: %s is %s but %s is %s"
                % (op.type, xs[0], vx.dtype, ys[0], vy.dtype)))
        elif not _broadcastable(vx.shape, vy.shape):
            diags.append(make(
                "P004", label, 0, "block%d" % blk.idx,
                "%s:%s|%s" % (op.type, xs[0], ys[0]),
                "op %r shapes cannot broadcast: %s is %s but %s is %s"
                % (op.type, xs[0], vx.shape, ys[0], vy.shape)))
    elif op.type == "sum":
        dtypes = {}
        for name in op.input("X"):
            v = _find_var(blk, name)
            if v is not None and v.dtype:
                dtypes.setdefault(v.dtype, name)
        if len(dtypes) > 1:
            pretty = ", ".join("%s:%s" % (n, d)
                               for d, n in sorted(dtypes.items()))
            diags.append(make(
                "P003", label, 0, "block%d" % blk.idx,
                "sum:%s" % "|".join(sorted(dtypes)),
                "op 'sum' mixes dtypes across inputs (%s)" % pretty))


# --- P002 --------------------------------------------------------------

# attrs naming what a control-flow op binds inside its sub-block, and
# what it reads back out of it (layers/control_flow.py DynamicRNN)
_BOUND_ATTRS = ("step_inner", "static_inner", "mem_pre")
_READ_BACK_ATTRS = ("out_inner", "mem_update")


def _names_in(op, attrs) -> Set[str]:
    return {n for a in attrs for n in (op.attrs.get(a) or ()) if n}


def _bound_inside(op) -> Set[str]:
    return _names_in(op, _BOUND_ATTRS)


def _collect_reads(program, blk, consumed):
    for op in blk.ops:
        consumed.update(op.input_arg_names)
        consumed.update(_names_in(op, _READ_BACK_ATTRS))
        sub_idx = op.attrs.get("sub_block")
        if isinstance(sub_idx, int) and 0 <= sub_idx < len(program.blocks):
            _collect_reads(program, program.block(sub_idx), consumed)


def _check_dead_writes(program, feeds, fetches, diags, label):
    consumed: Set[str] = set(fetches)
    _collect_reads(program, program.global_block(), consumed)
    for blk in program.blocks:
        # autodiff differentiates the forward region, implicitly
        # consuming every value produced before it
        produced_before_autodiff: Set[str] = set()
        acc: Set[str] = set()
        for op in blk.ops:
            if op.type == "autodiff":
                produced_before_autodiff = acc
                break
            acc.update(op.output_arg_names)
        for op in blk.ops:
            if op.type in SIDE_EFFECT_OPS or "sub_block" in op.attrs:
                continue
            outs = op.output_arg_names
            if not outs:
                continue
            live = []
            for name in outs:
                var = _find_var(blk, name)
                if (name in consumed
                        or name in produced_before_autodiff
                        or (var is not None
                            and (var.persistable or _is_parameter(var)))):
                    live.append(name)
            if not live:
                diags.append(make(
                    "P002", label, 0, "block%d" % blk.idx,
                    "%s:%s" % (op.type, outs[0]),
                    "op %r writes only %s — never consumed, fetched, "
                    "or persisted" % (op.type, ", ".join(map(repr, outs)))))


# --- executor pre-flight ----------------------------------------------

def preflight(program, feeds: Iterable[str] = (),
              fetches: Iterable[str] = ()) -> None:
    """Opt-in Executor.run pre-flight: raise ProgramVerifyError on
    error-severity findings (dead writes are pruning fodder at run
    time, so P002 warnings never block a run). Memoized per
    (program version, feed/fetch signature) — the pre-run cost on a
    cached training step is one dict lookup."""
    key = (program.version, frozenset(feeds),
           tuple(sorted(str(f) if not hasattr(f, "name") else f.name
                        for f in fetches)))
    memo = getattr(program, "_preflight_ok", None)
    if memo is not None and key in memo:
        return
    diags = [d for d in verify_program(program, feeds=feeds,
                                       fetches=fetches,
                                       label="<program uid=%d>" % program.uid)
             if d.severity == "error"]
    if diags:
        raise ProgramVerifyError(diags)
    if memo is None:
        memo = program._preflight_ok = set()
    if len(memo) > 64:  # programs mutate; don't hoard dead signatures
        memo.clear()
    memo.add(key)
