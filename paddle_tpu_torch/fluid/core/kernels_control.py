"""Control-flow kernels: While, LoDTensorArray ops, DynamicRNN, beam
search (counterpart of paddle_tpu/fluid/core/kernels_control.py, as plain
torch ops driven by the host).

The JAX package traces these ops into one XLA program (a peeled While
plus one `lax.fori_loop`, a `lax.scan` for DynamicRNN). The port runs
them eagerly, op by op, with the same semantics:

* Loop counters and limits stay on the host. `host_names` finds the
  values a While condition or a tensor-array index reads, and the
  counter ops (`fill_constant`, `increment`, `less_than`, ...) that
  produce them; `fill_constant` then builds them as CPU tensors and the
  counter ops keep them there (`place_hosted`). A loop trip reads its
  condition and its array slots from host values: no device sync.
* `LoDTensorArray` is a host list of (value, side-bands) items;
  `array_write` / `array_read` move values *and* their LoD and beam
  side-bands through it.
* `while` peels trips until the shapes of everything the body writes
  stop changing (`_MIN_PEEL` at least), counts the remaining trips by
  simulating the counter chain on the host, and runs them. A beam loop
  may stop early once every beam has emitted the end id (the JAX
  package's `lax.while_loop` over the `@BEAM_ALIVE` bands): the test
  `any(alive)` is the only read of the device in the loop, one per trip
  after the peel. The slots an early exit never wrote are rebuilt as
  the frozen beams would have written them (`_fill_frozen_tail`), so the
  decode is the same with the exit on or off.
* Beam search keeps beams full-width (exactly `beam_size` live or frozen
  candidates per source every step): finished prefixes re-emit the end
  id at their frozen score, parents travel as the `@BEAM_PARENTS`
  side-band. Ties rank lowest index first, as `lax.top_k` and the
  stable `jnp.argsort` rank them.
* `dynamic_rnn` runs its sub-block once per time step over the exact
  longest sequence (from the host copy of the offsets), dense over the
  whole batch; finished sequences keep their memories under a mask.
  Autograd differentiates the loop.

RNG: a sub-block draws from a fresh counter on the run's key, as the
JAX package's sub-`LoweringContext` does. XLA traces a `lax.scan` body
once, so every DynamicRNN step draws the same keys; the port restarts
the counter each step. A While's peeled trips advance it; its remaining
trips (one traced body in the JAX package) all draw from where the peel
left it.
"""

from __future__ import annotations

import os
import weakref
from typing import Any, Dict, List

import numpy as np
import torch

from .kernels_nn import stable_topk
from .kernels_rnn import _full_steps, _seq_T, packed_to_padded, \
    padded_to_packed
from .kernels_sequence import BEAM_PARENTS, LOD_SRC, lod_key
from .registry import LoweringContext, register_op, torch_dtype

# side-band suffixes that follow a value through tensor arrays
BEAM_SCORES = "@BEAM_SCORES"
BEAM_ALIVE = "@BEAM_ALIVE"
BEAM_LENS = "@BEAM_LENS"
_SIDEBANDS = ("@LOD0", BEAM_PARENTS, BEAM_SCORES, BEAM_ALIVE, LOD_SRC,
              BEAM_LENS)

MAX_WHILE_ITERS = 10000

# kill switch for the beam early exit (PADDLE_TPU_NO_EARLY_EXIT=1 runs
# every trip, the fixed-trip schedule); tests toggle the attribute
EARLY_EXIT_ENABLED = os.environ.get("PADDLE_TPU_NO_EARLY_EXIT", "0") != "1"


def get_sidebands(env, name) -> Dict[str, Any]:
    return {s: env[name + s] for s in _SIDEBANDS if (name + s) in env}


def set_sidebands(ctx, name, bands: Dict[str, Any], hosts=None):
    """Bind `bands` as `name`'s side-bands; `hosts` maps a suffix to the
    host copy of its offsets where the host knows them."""
    for s, v in bands.items():
        ctx.env[name + s] = v
        if hosts and s in hosts:
            ctx.note_host_lod(v, hosts[s])
    if bands:
        ctx.has_lod = True


def _host_offsets(ctx, host):
    """(device tensor, host copy) of offsets the host computes."""
    host = np.asarray(host, np.int32)
    return to_device_async(torch.from_numpy(host.copy()), ctx.device), host


def _host_int(i) -> int:
    """A loop counter or array index as a Python int. The executor keeps
    counters on the host (`host_names`), so this reads no device."""
    return int(i.reshape(-1)[0]) if isinstance(i, torch.Tensor) else int(i)


def _truth(v) -> bool:
    return bool(v.reshape(-1)[0])


# ---------------------------------------------------------------------------
# host-side loop counters
# ---------------------------------------------------------------------------

# ops a counter-only condition chain may consist of (simulated on the
# host to count loop trips; the JAX package's _SIM_OPS)
_SIM_OPS = frozenset(
    ["increment", "less_than", "less_equal", "greater_than", "greater_equal",
     "equal", "not_equal", "fill_constant", "assign", "cast", "scale",
     "elementwise_add", "elementwise_sub", "logical_and", "logical_or",
     "logical_not"]
)
# ops that may produce a host value, and the ops that take host values
# as they are (they read a counter as an int or move it whole)
_HOST_PRODUCERS = _SIM_OPS | {"array_length"}
_HOST_CONSUMERS = frozenset(
    ["array_write", "array_read", "array_length", "while", "dynamic_rnn",
     "beam_search_decode", "shrink_rnn_memory", "print"]
)
# ops whose "I" input indexes a tensor array or a rank table
_INDEXED_OPS = ("array_write", "array_read", "shrink_rnn_memory")


def host_names(program) -> frozenset:
    """The names the executor keeps on the host: each While's condition
    and each tensor-array index, closed over the counter ops
    (`_HOST_PRODUCERS`) that compute them, in every block. Memoized on
    the program per version."""
    memo = getattr(program, "_host_names", None)
    if memo is not None and memo[0] == program.version:
        return memo[1]
    names = set()
    for blk in program.blocks:
        for op in blk.ops:
            if op.type == "while":
                names.add(op.inputs["Condition"][0])
            elif op.type in _INDEXED_OPS:
                names |= set(op.inputs.get("I", []))
    changed = bool(names)
    while changed:
        changed = False
        for blk in program.blocks:
            for op in blk.ops:
                if op.type in _HOST_PRODUCERS and \
                        set(op.output_arg_names) & names:
                    new = set(op.input_arg_names) - names
                    if new:
                        names |= new
                        changed = True
    frozen = frozenset(names)
    program._host_names = (program.version, frozen)
    return frozen


def to_device_async(t, device):
    """A host tensor on `device` through pinned memory, without a wait
    on the card (a plain copy from pageable memory synchronizes)."""
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def place_hosted(ctx, op, ins, hosted):
    """Keep the counter chain on the host: a counter op whose output the
    program keeps on the host takes its host-kept inputs on the host (a
    read of the card only when one was computed there); any other op
    takes a host-kept input on the run's device."""
    if ctx.device.type == "cpu" or op.type in _HOST_CONSUMERS:
        return
    to_host = op.type in _HOST_PRODUCERS and any(
        n in hosted for n in op.output_arg_names)
    for slot, names in op.inputs.items():
        vals = ins[slot]
        for j, n in enumerate(names):
            v = vals[j]
            if n not in hosted or not isinstance(v, torch.Tensor):
                continue
            if to_host and v.device.type != "cpu":
                vals[j] = v.cpu()
            elif not to_host and v.device != ctx.device:
                vals[j] = to_device_async(v, ctx.device)


# ---------------------------------------------------------------------------
# tensor arrays
# ---------------------------------------------------------------------------


class TensorArray(object):
    """LoDTensorArray: a host list of (value, side-bands) items. Items
    may differ in shape (beam search's step 0 has one row per source,
    later steps beam_size)."""

    def __init__(self):
        self.items: List[Any] = []
        self.bands: List[Dict[str, Any]] = []

    def write(self, i, value, bands):
        i = _host_int(i)
        while len(self.items) <= i:
            self.items.append(None)
            self.bands.append({})
        self.items[i] = value
        self.bands[i] = dict(bands)

    def read(self, i):
        i = _host_int(i)
        if i < 0 or i >= len(self.items) or self.items[i] is None:
            raise IndexError("LoDTensorArray read at slot %d: slot never "
                             "written (length %d)" % (i, len(self.items)))
        return self.items[i], self.bands[i]

    def __len__(self):
        return len(self.items)


@register_op("array_write")
def _array_write(ctx, ins, attrs):
    env = ctx.env
    arr_name = ctx.op.outputs["Out"][0]
    x_name = ctx.op.inputs["X"][0]
    arr = env.get(arr_name)
    if not isinstance(arr, TensorArray):
        arr = TensorArray()
    arr.write(ins["I"][0], env[x_name], get_sidebands(env, x_name))
    env[arr_name] = arr
    return {}


@register_op("array_read")
def _array_read(ctx, ins, attrs):
    env = ctx.env
    value, bands = ins["X"][0].read(ins["I"][0])
    out_name = ctx.op.outputs["Out"][0]
    env[out_name] = value
    # clear stale side-bands on the out name, then install the item's
    for s in _SIDEBANDS:
        env.pop(out_name + s, None)
    set_sidebands(ctx, out_name, bands)
    return {}


@register_op("array_length")
def _array_length(ctx, ins, attrs):
    n = len(ins["X"][0])
    device = torch.device("cpu") if ctx.op.outputs["Out"][0] in \
        ctx.host_names else ctx.device
    return {"Out": torch.full((1,), n, dtype=torch.int64, device=device)}


# ---------------------------------------------------------------------------
# while
# ---------------------------------------------------------------------------

# peel at least this many trips before counting the rest (beam search
# reaches its full-width steady state after 2 steps)
_MIN_PEEL = 1

# the last `while`: trips peeled, trips counted after the peel, trips of
# those run (fewer on an early exit), and whether the exit was armed
LAST_WHILE_STATS = {"peeled": 0, "remaining": 0, "executed": 0,
                    "early_exit_armed": False}


def _stats(peeled, remaining=0, executed=0, armed=False):
    LAST_WHILE_STATS.update(peeled=peeled, remaining=remaining,
                            executed=executed, early_exit_armed=armed)


def _env_signature(env, names):
    return {n: (tuple(v.shape), str(v.dtype)) for n in names
            for v in [env.get(n)] if isinstance(v, torch.Tensor)}


def _cond_slice_ops(sub, cond_name):
    """The sub-block ops that (transitively) produce the condition,
    iterated to a fixed point so multi-op counter chains resolve."""
    needed = {cond_name}
    keep = []
    for _ in range(len(sub.ops) + 1):
        keep = [op for op in sub.ops if set(op.output_arg_names) & needed]
        new_needed = set(needed)
        for op in keep:
            new_needed |= set(op.input_arg_names)
        if new_needed == needed:
            return keep
        needed = new_needed
    return keep


def _count_remaining(sub, cond_name, env, cap):
    """Simulate the counter-only condition chain on host copies to count
    the trips left; None when the chain holds another op."""
    from .lowering import run_op

    slice_ops = _cond_slice_ops(sub, cond_name)
    if any(op.type not in _SIM_OPS for op in slice_ops):
        return None
    names = {cond_name}
    for op in slice_ops:
        names |= set(op.input_arg_names) | set(op.output_arg_names)
    sim_env = {n: env[n].detach().cpu() for n in names
               if isinstance(env.get(n), torch.Tensor)}
    sim_ctx = LoweringContext(sub, None, torch.device("cpu"))
    count = 0
    while _truth(sim_env[cond_name]):
        if count >= cap:
            raise RuntimeError("while op exceeded %d iterations" % cap)
        for op in slice_ops:
            run_op(sim_ctx, op, sim_env)
        count += 1
    return count


class _Steady(object):
    """What the trips after the peel carry: the body's tensor arrays,
    the written ones, the beam arrays among those and the alive bands
    the early exit reads."""

    def __init__(self, arr_names, written_arrs, beam_arrs, alive_names,
                 early):
        self.arr_names = arr_names
        self.written_arrs = written_arrs
        self.beam_arrs = beam_arrs
        self.alive_names = alive_names
        self.early = early


def _steady_plan(sub, env, written, iters, downstream):
    """The JAX package's `_while_fori` preconditions, checked before any
    trip after the peel: None where it keeps unrolling (the body reads
    an array's length, a written array holds other slots than the
    counter's, a read-only array's items differ in shape, dtype or
    side-bands), which runs every trip without an early exit."""
    carried = []
    for n in written:
        if isinstance(env.get(n), torch.Tensor):
            carried.append(n)
            for s in _SIDEBANDS:
                if (n + s) in env and (n + s) not in carried:
                    carried.append(n + s)
    arr_names, written_arrs = [], set()
    for op in sub.ops:
        if op.type == "array_length" and any(
                isinstance(env.get(n), TensorArray)
                for n in op.inputs.get("X", [])):
            return None
        if op.type in ("array_write", "array_read"):
            for names in list(op.inputs.values()) + list(
                    op.outputs.values()):
                for n in names:
                    if isinstance(env.get(n), TensorArray) and \
                            n not in arr_names:
                        arr_names.append(n)
            if op.type == "array_write":
                written_arrs |= set(op.outputs.get("Out", []))
    for n in arr_names:
        arr = env[n]
        if n in written_arrs:
            if len(arr) != iters + 1:
                return None
        else:
            shapes = {(tuple(v.shape), str(v.dtype)) for v in arr.items}
            keys = {tuple(sorted(b)) for b in arr.bands}
            if len(shapes) != 1 or len(keys) != 1:
                return None
    alive_names = sorted(
        n for n in carried
        if n.endswith(BEAM_ALIVE) and env[n].dtype == torch.bool)
    early = bool(alive_names) and EARLY_EXIT_ENABLED
    # only beam emission arrays (they carry @BEAM_PARENTS) stand still
    # once every beam is dead: arm the exit only when no later op or
    # fetch reads another written array or a loop variable, and some
    # written array is a beam array
    beam_arrs = {n for n in written_arrs if n in arr_names and any(
        s.endswith(BEAM_PARENTS) for s in env[n].bands[-1])}
    if early and ((((written_arrs - beam_arrs) | set(carried))
                   & downstream) or not beam_arrs):
        early = False
    return _Steady(arr_names, written_arrs, beam_arrs, alive_names, early)


def _any_alive(env, names) -> bool:
    """Whether some beam is still alive: the loop's one device read."""
    return bool(torch.stack([env[n].any() for n in names]).any())


def _run_steady(sub_ctx, sub, env, plan, remaining, iters):
    """The trips after the peel: each draws the keys of the first (the
    JAX package traces that body once); with the exit armed, stop once
    every beam is dead and rebuild the slots the rest would have
    written."""
    from .lowering import run_ops

    key_counter = sub_ctx._rng_counter
    executed = 0
    while executed < remaining:
        if plan.early and not _any_alive(env, plan.alive_names):
            break
        sub_ctx._rng_counter = key_counter
        run_ops(sub_ctx, sub.ops, env)
        executed += 1
    full = iters + remaining + 1
    for n in plan.arr_names:
        arr = env[n]
        if n in plan.written_arrs and len(arr) < full:
            if n in plan.beam_arrs:
                _fill_frozen_tail(arr, full)
            else:  # never read later (the gate): zeros, as JAX leaves them
                v, b = arr.items[-1], arr.bands[-1]
                zero = (torch.zeros_like(v),
                        {s: torch.zeros_like(x) for s, x in b.items()})
                while len(arr) < full:
                    arr.items.append(zero[0])
                    arr.bands.append(dict(zero[1]))
    _stats(iters, remaining, executed, plan.early)


def _fill_frozen_tail(arr, full):
    """Append the slots an early-exited beam loop never wrote, up to
    `full`. Had the loop run on, each of those steps would have written
    the all-frozen emission: ids all end_id, scores and LoD bands those
    of the exit slot, identity parents (stable top-k over the sorted
    frozen scores), alive all False (as in the exit slot)."""
    value, bands = arr.items[-1], arr.bands[-1]
    tail = {}
    for s, v in bands.items():
        if s.endswith(BEAM_PARENTS):
            v = torch.arange(v.shape[0], dtype=v.dtype, device=v.device)
        tail[s] = v
    while len(arr) < full:
        arr.items.append(value)
        arr.bands.append(dict(tail))


@register_op("while")
def _while(ctx, ins, attrs):
    """Counter-bounded While: peel trips until the shapes the body
    writes stop changing, count the rest on the host, run them (the JAX
    package's peel + `lax.fori_loop`, or its `lax.while_loop` when a
    beam loop may stop early)."""
    from .lowering import run_ops

    env = ctx.env
    op = ctx.op
    cond_name = op.inputs["Condition"][0]
    program = ctx.block.program
    sub = program.block(attrs["sub_block"])
    sub_ctx = ctx.sub_context(sub)
    # names read after this while, directly, through sub-blocks or as
    # fetches: values frozen at an early exit must not be seen there.
    # The counter chain is exempt: it reports the exit step, as the
    # reference's RecurrentGradientMachine stops where the beams died
    reads = set(ctx.fetch_names) | set(ctx.downstream_reads)
    seen_self = False
    for later in ctx.block.ops:
        if later is op:
            seen_self = True
        elif seen_self:
            reads |= set(later.input_arg_names)
            reads |= program._sub_block_outer_reads(later)
    cond_chain = set()
    for cop in _cond_slice_ops(sub, cond_name):
        cond_chain |= set(cop.output_arg_names)
    sub_ctx.downstream_reads = frozenset(reads - cond_chain)
    max_iters = int(attrs.get("max_iters", MAX_WHILE_ITERS))
    written = []
    for sop in sub.ops:
        for n in sop.output_arg_names:
            if n not in written:
                written.append(n)

    prev_sig = None
    iters = 0
    steady_ok = True
    while True:
        if not _truth(env[cond_name]):
            _stats(iters)
            return {}
        sig = _env_signature(env, written)
        if steady_ok and iters >= _MIN_PEEL and sig == prev_sig and sig:
            remaining = _count_remaining(sub, cond_name, env,
                                         max_iters - iters)
            if remaining is None:
                steady_ok = False
            elif remaining == 0:
                _stats(iters)
                return {}
            else:
                plan = _steady_plan(sub, env, written, iters,
                                    sub_ctx.downstream_reads)
                if plan is None:
                    steady_ok = False
                else:
                    _run_steady(sub_ctx, sub, env, plan, remaining, iters)
                    return {}
        if iters >= max_iters:
            raise RuntimeError("while op exceeded %d iterations" % iters)
        prev_sig = sig
        run_ops(sub_ctx, sub.ops, env)
        iters += 1


# ---------------------------------------------------------------------------
# dynamic_rnn: the sub-block once per time step (DynamicRNN layer sugar)
# ---------------------------------------------------------------------------


@register_op("dynamic_rnn")
def _dynamic_rnn(ctx, ins, attrs):
    from .lowering import run_ops

    env = ctx.env
    op = ctx.op
    sub = ctx.block.program.block(attrs["sub_block"])
    step_outer = op.inputs.get("StepIn", [])
    step_inner = attrs["step_inner"]
    static_outer = op.inputs.get("Static", [])
    static_inner = attrs.get("static_inner", [])
    mem_pre = attrs["mem_pre"]  # inner pre-state names
    mem_update = attrs["mem_update"]  # inner updated-state names
    mem_init = attrs["mem_init_names"]  # outer init var name or ""
    mem_shapes = attrs.get("mem_shapes", [])
    mem_values = attrs.get("mem_values", [])
    mem_dtypes = attrs.get("mem_dtypes", [])
    out_inner = attrs["out_inner"]

    x0_name = step_outer[0]
    offsets = env[lod_key(x0_name)]
    total = env[x0_name].shape[0]
    T = _seq_T(ctx, total, offsets)
    full = _full_steps(ctx, offsets)
    B = offsets.shape[0] - 1

    xs, mask = [], None
    for name in step_outer:
        p, m = packed_to_padded(env[name], offsets, T)  # [B, T, ...]
        xs.append(p.transpose(0, 1))  # [T, B, ...]
        if mask is None:
            mask = m.transpose(0, 1)  # [T, B]

    carry = {}
    for j, pre in enumerate(mem_pre):
        if mem_init[j]:
            carry[pre] = env[mem_init[j]]
        else:
            shape = (B,) + tuple(int(s) for s in mem_shapes[j]
                                 if int(s) > 0)
            carry[pre] = torch.full(shape, float(mem_values[j]),
                                    dtype=torch_dtype(mem_dtypes[j]),
                                    device=ctx.device)

    sub_ctx = ctx.sub_context(sub)
    # the sub-block reads weights and static inputs from outside
    base_env = {k: v for k, v in env.items()
                if not isinstance(v, TensorArray)}
    for so, si in zip(static_outer, static_inner):
        base_env[si] = env[so]

    ys = [[] for _ in out_inner]
    for t in range(T):
        senv = dict(base_env)
        for si, x in zip(step_inner, xs):
            senv[si] = x[t]
        senv.update(carry)
        sub_ctx._rng_counter = 0  # every step draws the same keys
        run_ops(sub_ctx, sub.ops, senv)
        for pre, upd in zip(mem_pre, mem_update):
            new = senv[upd]
            if t >= full:  # some sequence has ended: it keeps its state
                keep = mask[t].reshape((-1,) + (1,) * (new.dim() - 1))
                new = torch.where(keep, new, carry[pre])
            carry[pre] = new
        for k, o in enumerate(out_inner):
            ys[k].append(senv[o])

    outs = [padded_to_packed(torch.stack(y, dim=1), offsets, total)
            for y in ys]
    for name in op.outputs["Out"]:
        ctx.set_lod(name, offsets)
    return {"Out": outs}


# ---------------------------------------------------------------------------
# beam search (full-width static-shape design)
# ---------------------------------------------------------------------------

_NEG_INF = -1e9


@register_op("beam_search")
def _beam_search(ctx, ins, attrs):
    env = ctx.env
    op = ctx.op
    pre_ids_name = op.inputs["pre_ids"][0]
    pre_ids = ins["pre_ids"][0]  # [R, 1] int
    ids = ins["ids"][0]  # [R, K] int
    scores = ins["scores"][0]  # [R, K] float
    B = int(attrs["beam_size"])
    end_id = int(attrs["end_id"])
    dev = scores.device

    R = pre_ids.shape[0]
    K = ids.shape[1]
    pre_bands = get_sidebands(env, pre_ids_name)
    # rows per source: the outer LoD level's SHAPE gives the source
    # count; widths must be uniform (exactly beam_size rows per source
    # after the first step), and a fed 2-level LoD must be uniform too
    if LOD_SRC in pre_bands:
        src = pre_bands[LOD_SRC]
        S = int(src.shape[0]) - 1
        host = ctx.host_lod(src)
        if S < 1 or R % S or (host is not None and
                              (np.diff(host) != R // S).any()):
            raise ValueError(
                "beam_search: %d prefixes over %d sources (outer LoD %s): "
                "every source must hold the same number of prefixes"
                % (R, S, None if host is None else host.tolist()))
        width = R // S
    else:
        # no outer level: the first step (width 1) unless this is our
        # own previous full-width output
        width = B if BEAM_PARENTS in pre_bands else 1
        S = R // width

    pre_score = pre_bands.get(BEAM_SCORES)
    if pre_score is None:
        pre_score = torch.zeros((R,), dtype=scores.dtype, device=dev)
    alive = pre_bands.get(BEAM_ALIVE)
    if alive is None:
        alive = torch.ones((R,), dtype=torch.bool, device=dev)
    alive = alive & (pre_ids.reshape(-1) != end_id)

    # candidates per source: width*K expansions + width "frozen" ones (an
    # ended prefix re-emits end_id at its frozen score; a live prefix's
    # frozen slot is -inf)
    exp_scores = torch.where(alive[:, None], scores, _NEG_INF)
    frozen_scores = torch.where(alive, _NEG_INF, pre_score)
    cand_scores = torch.cat([exp_scores.reshape(S, width * K),
                             frozen_scores.reshape(S, width)], dim=1)
    cand_ids = torch.cat([ids.reshape(S, width * K),
                          torch.full((S, width), end_id, dtype=ids.dtype,
                                     device=dev)], dim=1)
    # local parent (row within its source) of each candidate
    rows = torch.arange(width, dtype=torch.int64, device=dev)
    local_parent = torch.cat([rows[:, None].expand(width, K).reshape(-1),
                              rows])

    top_scores, top_idx = stable_topk(cand_scores, B)  # [S, B]
    sel_ids = torch.gather(cand_ids, 1, top_idx)
    first = torch.arange(S, dtype=torch.int64, device=dev)[:, None] * width
    sel_parent = local_parent[top_idx] + first  # global row into R

    out_rows = S * B
    selected_ids = sel_ids.reshape(out_rows, 1)
    selected_scores = top_scores.reshape(out_rows, 1).to(scores.dtype)
    parents = sel_parent.reshape(out_rows).to(torch.int32)
    new_alive = selected_ids.reshape(-1) != end_id
    row_off, row_host = _host_offsets(ctx, np.arange(out_rows + 1))
    src_off, src_host = _host_offsets(ctx, np.arange(S + 1) * B)
    for out_name in (op.outputs["selected_ids"][0],
                     op.outputs["selected_scores"][0]):
        set_sidebands(ctx, out_name, {
            "@LOD0": row_off, LOD_SRC: src_off, BEAM_PARENTS: parents,
            BEAM_SCORES: selected_scores.reshape(-1),
            BEAM_ALIVE: new_alive,
        }, hosts={"@LOD0": row_host, LOD_SRC: src_host})
    return {"selected_ids": selected_ids, "selected_scores": selected_scores}


@register_op("beam_search_decode")
def _beam_search_decode(ctx, ins, attrs):
    """Backtrack the ids / scores arrays into whole sentences: parent
    pointers are explicit side-bands, the walk a host loop over the
    array's length with one gather per step. Out: padded [S*beam, T+1]
    sentences and a length vector (up to and including the first end
    id), with packed-LoD offsets so sequence ops can read the result."""
    op = ctx.op
    ids_arr: TensorArray = ins["Ids"][0]
    scores_arr: TensorArray = ins["Scores"][0]
    T = len(ids_arr) - 1  # item 0 is the init (start-token) step
    if T < 1:
        raise ValueError("beam_search_decode needs at least one search step")
    last_v, last_b = ids_arr.read(T)
    R = last_v.shape[0]  # S * beam
    dev = last_v.device

    row = torch.arange(R, dtype=torch.int64, device=dev)
    toks, tok_scores, alive_flags = [], [], []
    for t in range(T, 0, -1):
        v, b = ids_arr.read(t)
        sv, _ = scores_arr.read(t)
        toks.append(v.reshape(-1)[row])
        tok_scores.append(sv.reshape(-1)[row])
        alive_flags.append(b[BEAM_ALIVE][row])
        row = b[BEAM_PARENTS][row].long()
    v0, _ = ids_arr.read(0)
    sv0, _ = scores_arr.read(0)
    toks.append(v0.reshape(-1)[row])
    tok_scores.append(sv0.reshape(-1)[row])
    alive_flags.append(torch.ones((R,), dtype=torch.bool, device=dev))

    id_dtype = toks[0].dtype
    for tk in toks:
        id_dtype = torch.promote_types(id_dtype, tk.dtype)
    ids_mat = torch.stack([tk.to(id_dtype) for tk in toks[::-1]], dim=1)
    scores_mat = torch.stack(tok_scores[::-1], dim=1)  # [R, T+1]
    alive_mat = torch.stack(alive_flags[::-1], dim=1)

    # length = up to and including the first end token (first not-alive)
    ended = ~alive_mat
    first_end = torch.argmax(ended.to(torch.int32), dim=1)
    lens = torch.where(ended.any(dim=1), first_end + 1,
                       torch.full_like(first_end, T + 1)).to(torch.int32)

    src_off = last_b.get(LOD_SRC)
    # num_results_per_sample < beam: keep each source's best n rows by
    # final score, in a stable order (jnp.argsort is stable)
    n_res = int(attrs.get("num_results_per_sample", 0) or 0)
    beam = int(attrs.get("beam_width", 0) or 0)
    if n_res and beam and n_res < beam and R % beam == 0:
        S = R // beam
        final_sc, _ = scores_arr.read(T)
        per_src = final_sc.reshape(S, beam)
        order = torch.sort(-per_src, dim=1, stable=True).indices[:, :n_res]
        take = (torch.arange(S, dtype=torch.int64, device=dev)[:, None]
                * beam + order).reshape(-1)
        ids_mat = ids_mat[take]
        scores_mat = scores_mat[take]
        lens = lens[take]
        src_off, _ = _host_offsets(ctx, np.arange(S + 1) * n_res)

    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(lens, 0, dtype=torch.int32)])
    for out_name in (op.outputs["SentenceIds"][0],
                     op.outputs["SentenceScores"][0]):
        bands = {"@LOD0": offsets, BEAM_LENS: lens}
        if src_off is not None:
            bands[LOD_SRC] = src_off
        set_sidebands(ctx, out_name, bands)
    outs = {"SentenceIds": ids_mat, "SentenceScores": scores_mat}
    if "SentenceLens" in op.outputs:
        outs["SentenceLens"] = lens
    return outs


@register_op("beam_init")
def _beam_init(ctx, ins, attrs):
    """Generation-start ids and scores (one <bos> per source row of X)
    with the 2-level side-bands beam_search expects (the reference
    builds them inside RecurrentGradientMachine's generation path)."""
    x = ins["X"][0]
    B = x.shape[0]
    ids = torch.full((B, 1), int(attrs["bos_id"]), dtype=torch.int32,
                     device=x.device)
    scores = torch.ones((B, 1), dtype=torch.float32, device=x.device)
    off, host = _host_offsets(ctx, np.arange(B + 1))
    for out_name in (ctx.op.outputs["Ids"][0], ctx.op.outputs["Scores"][0]):
        set_sidebands(ctx, out_name, {"@LOD0": off, LOD_SRC: off},
                      hosts={"@LOD0": host})
    return {"Ids": ids, "Scores": scores}


# ---------------------------------------------------------------------------
# LoD tensor <-> tensor array over a rank table
# ---------------------------------------------------------------------------


def _col(v, ndim):
    return v.reshape((-1,) + (1,) * (ndim - 1))


@register_op("lod_tensor_to_array")
def _lod_tensor_to_array(ctx, ins, attrs):
    """Scatter a ragged batch into a tensor array of time steps in rank
    table order (reference lod_tensor_to_array_op.cc): entry t holds row
    t of every sequence, longest first. Entries keep the static [n, D]
    shape with zero rows once a sequence has ended (shrink_rnn_memory
    masks instead of shrinking). The array holds exactly the longest
    sequence's steps (the JAX package pads to its power-of-two bucket)."""
    x_name = ctx.op.inputs["X"][0]
    x = ins["X"][0]
    table = ins["RankTable"][0]
    offsets = ctx.env[lod_key(x_name)]
    order = table[:, 0].long()
    total = x.shape[0]
    T = _seq_T(ctx, total, offsets)
    start, end = offsets[order], offsets[order + 1]
    arr = TensorArray()
    for t in range(T):
        src = start + t
        valid = _col(src < end, x.dim())
        row = x.index_select(0, torch.clamp(src, 0, total - 1).long())
        arr.write(t, torch.where(valid, row, 0.0), {})
    ctx.env[ctx.op.outputs["Out"][0]] = arr
    return {}


@register_op("array_to_lod_tensor")
def _array_to_lod_tensor(ctx, ins, attrs):
    """Inverse of lod_tensor_to_array: gather the time-step entries back
    into the packed ragged layout of the original sequence order."""
    arr = ins["X"][0]
    table = ins["RankTable"][0]
    order = table[:, 0].long()
    lengths = table[:, 1]
    n = order.shape[0]
    T = len(arr)
    stacked = torch.stack([arr.read(t)[0] for t in range(T)])  # [T, n, D]
    dev = stacked.device
    orig_len = torch.zeros((n,), dtype=torch.int32, device=dev).scatter(
        0, order, lengths.to(torch.int32))
    offsets = torch.cat([torch.zeros((1,), dtype=torch.int32, device=dev),
                         torch.cumsum(orig_len, 0, dtype=torch.int32)])
    total = T * n
    pos = torch.arange(total, dtype=torch.int32, device=dev)
    seq = torch.searchsorted(offsets, pos, right=True) - 1
    seq_c = torch.clamp(seq, 0, n - 1)
    rank_of = torch.zeros((n,), dtype=torch.int64, device=dev).scatter(
        0, order, torch.arange(n, dtype=torch.int64, device=dev))
    t_idx = torch.clamp(pos - offsets[seq_c], 0, T - 1).long()
    out = stacked[t_idx, rank_of[seq_c]]
    out = torch.where(_col(pos < offsets[-1], out.dim()), out, 0.0)
    ctx.set_lod(ctx.op.outputs["Out"][0], offsets)
    return {"Out": out}


@register_op("shrink_rnn_memory")
def _shrink_rnn_memory(ctx, ins, attrs):
    """Reference shrink_rnn_memory_op trims the state to the sequences
    still alive at step I; the static-shape design masks the finished
    ones to zero instead (see lod_tensor_to_array)."""
    x = ins["X"][0]
    alive = ins["RankTable"][0][:, 1] > _host_int(ins["I"][0])
    return {"Out": torch.where(_col(alive, x.dim()), x, 0.0)}


# ---------------------------------------------------------------------------
# print
# ---------------------------------------------------------------------------

# print-op counters keyed by the Operator, so first_n holds across runs;
# weak keys: they die with the program
_PRINT_COUNTS = weakref.WeakKeyDictionary()


class _GradTap(torch.autograd.Function):
    """Identity whose backward hands the cotangent to `emit`."""

    @staticmethod
    def forward(ctx, x, emit):
        ctx.emit = emit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.emit("@GRAD", g)
        return g, None


@register_op("print")
def _print_op(ctx, ins, attrs):
    """Debug print of a tensor's value where the op runs (reference
    layers/control_flow.py:149 Print -> operators/print_op.cc), and of
    its gradient in the backward when print_phase includes it. A debug
    op: it reads the value back to the host."""
    x = ins["In"][0]
    name = (ctx.op.inputs.get("In") or [""])[0]
    message = attrs.get("message", "") or ""
    first_n = int(attrs.get("first_n", -1))
    summarize = int(attrs.get("summarize", -1))
    phase = str(attrs.get("print_phase", "BOTH")).upper()
    show_name = attrs.get("print_tensor_name", True)
    show_type = attrs.get("print_tensor_type", True)
    show_shape = attrs.get("print_tensor_shape", True)
    lod = ctx.env.get(lod_key(name)) if attrs.get("print_tensor_lod",
                                                   True) else None
    # per-direction budgets: first_n=N means N forward prints AND N
    # backward prints, as the reference's print_op counts them
    counter = _PRINT_COUNTS.setdefault(ctx.op, {"": 0, "@GRAD": 0})

    def emit(tag, val, lod_val=None):
        # first_n <= 0 means no limit
        if 0 < first_n <= counter[tag]:
            return
        counter[tag] += 1
        val = val.detach()
        if val.dtype == torch.bfloat16:
            val = val.float()
        arr = val.cpu().numpy()
        flat = np.ravel(arr)
        if summarize >= 0:
            flat = flat[:summarize]
        bits = [message] if message else []
        if show_name:
            bits.append("name=%s%s" % (name, tag))
        if show_type:
            bits.append("dtype=%s" % arr.dtype)
        if show_shape:
            bits.append("shape=%s" % (arr.shape,))
        if lod_val is not None:
            bits.append("lod=%s" % lod_val.cpu().numpy().tolist())
        print("%s data=%s" % (" ".join(bits), flat), flush=True)

    if phase in ("FORWARD", "BOTH"):
        emit("", x, lod)
    if phase in ("BACKWARD", "BOTH") and x.requires_grad:
        x = _GradTap.apply(x, emit)
    return {"Out": x}
