"""Control-flow layers: While, DynamicRNN, tensor arrays, beam search,
IfElse, Switch, StaticRNN (counterpart of
paddle_tpu/fluid/layers/control_flow.py: the same IR builders).

API parity with reference python/paddle/v2/fluid/layers/control_flow.py
(While, DynamicRNN, array_read/array_write/array_length, create_array,
increment, less_than) and layers/nn.py beam_search / beam_search_decode.
The ops run eagerly on the executor's device (core/kernels_control.py).
"""

from __future__ import annotations

import contextlib

from ..core.program import unique_name
from ..layer_helper import LayerHelper

__all__ = [
    "While",
    "DynamicRNN",
    "ParallelDo",
    "get_places",
    "create_array",
    "array_read",
    "array_write",
    "array_length",
    "increment",
    "less_than",
    "beam_search",
    "beam_search_decode",
    "Print",
]


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_lod=True,
          print_phase="both"):
    """Debug print of a tensor's runtime value (reference
    layers/control_flow.py:149). Returns a pass-through of `input`; the
    message fires whenever the step computes the value — including the
    gradient when print_phase is 'backward'/'both'."""
    if print_phase.upper() not in ("FORWARD", "BACKWARD", "BOTH"):
        raise ValueError(
            "print_phase must be 'forward', 'backward' or 'both', got %r"
            % (print_phase,)
        )
    helper = LayerHelper("print", **locals())
    out = helper.create_tmp_variable(
        dtype=input.dtype, shape=tuple(input.shape)
    )
    helper.append_op(
        type="print",
        inputs={"In": [input]},
        outputs={"Out": [out]},
        attrs={
            "first_n": int(first_n),
            "summarize": int(summarize),
            "message": message or "",
            "print_tensor_name": print_tensor_name,
            "print_tensor_type": print_tensor_type,
            "print_tensor_shape": print_tensor_shape,
            "print_tensor_lod": print_tensor_lod,
            "print_phase": print_phase.upper(),
        },
    )
    return out


def get_places(device_count=None, device_type=None):
    """Reference layers/device.py get_places: the places a ParallelDo
    would split over: one per rank of the default mesh (informational,
    since the mesh executor does the splitting), else the CUDA devices
    torch sees, or one CPU place where there is none."""
    import torch

    from ...parallel.mesh import get_default_mesh
    from ..core import CPUPlace, CUDAPlace

    n = device_count
    if not n:
        mesh = get_default_mesh()
        if mesh is not None:
            place = CUDAPlace if mesh.device.type == "cuda" else \
                (lambda i: CPUPlace())
            return [place(i) for i in range(mesh.size)]
        n = torch.cuda.device_count()
        if not n:
            return [CPUPlace()]
    return [CUDAPlace(i) for i in range(int(n))]


class ParallelDo(object):
    """Data-parallel execution of a sub-region (reference
    layers/control_flow.py:233 ParallelDo -> operators/parallel_do_op.cc:27,
    which splits the batch across per-place scopes, runs the sub-block on
    each device and averages gradients).

    On a mesh the executor already runs every rank over its shard of
    the batch and sums the gradients, so the mesh IS the per-place split
    (the JAX package's redesign): the ops written inside `do()` inline
    straight into the parent program (no sub-block), and the per-place
    output-gather is the identity: a per-example output already spans
    the global batch, and a per-place mean over equal splits equals the
    global mean (a mean over the batch is global on a mesh). The reference API (read_input /
    write_output / `pd()`) is kept so scripts like benchmark/cluster/
    vgg16/vgg16_fluid.py run unchanged."""

    _BEFORE, _IN, _AFTER = 0, 1, 2

    def __init__(self, places, name=None):
        self.places = places
        self.inputs = []
        self.outputs = []
        self._status = self._BEFORE

    @contextlib.contextmanager
    def do(self):
        if self._status != self._BEFORE:
            raise RuntimeError("ParallelDo.do() may only be entered once")
        self._status = self._IN
        try:
            yield
        finally:
            self._status = self._AFTER

    def read_input(self, var):
        if self._status != self._IN:
            raise RuntimeError("read_input must be called inside do()")
        self.inputs.append(var)
        return var

    def write_output(self, var):
        if self._status != self._IN:
            raise RuntimeError("write_output must be called inside do()")
        self.outputs.append(var)

    def __call__(self, *args, **kwargs):
        if self._status != self._AFTER:
            raise ValueError(
                "ParallelDo output can only be retrieved after the do() block"
            )
        if not self.outputs:
            raise ValueError("ParallelDo has no output")
        return self.outputs[0] if len(self.outputs) == 1 else self.outputs


def increment(x, value=1.0, in_place=True):
    """x += value (reference control_flow.py increment)."""
    helper = LayerHelper("increment", **locals())
    if in_place:
        out = x
    else:
        out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(
        type="increment",
        inputs={"X": [x]},
        outputs={"Out": [out]},
        attrs={"step": float(value)},
    )
    return out


def less_than(x, y, cond=None, **ignored):
    helper = LayerHelper("less_than", **locals())
    if cond is None:
        cond = helper.create_tmp_variable(dtype="bool")
        cond.stop_gradient = True
    helper.append_op(
        type="less_than", inputs={"X": [x], "Y": [y]}, outputs={"Out": [cond]}
    )
    return cond


def create_array(dtype):
    """A LoDTensorArray variable (reference: LOD_TENSOR_ARRAY var type)."""
    helper = LayerHelper("array", **locals())
    arr = helper.main_program.current_block().create_var(
        name=unique_name("array"), dtype=dtype
    )
    arr.is_tensor_array = True
    arr.stop_gradient = True
    return arr


def array_write(x, i, array=None):
    helper = LayerHelper("array_write", **locals())
    if array is None:
        array = create_array(x.dtype)
    helper.append_op(
        type="array_write",
        inputs={"X": [x], "I": [i], "Array": [array]},
        outputs={"Out": [array]},
    )
    return array


def array_read(array, i):
    helper = LayerHelper("array_read", **locals())
    out = helper.create_tmp_variable(dtype=array.dtype)
    helper.append_op(
        type="array_read", inputs={"X": [array], "I": [i]}, outputs={"Out": [out]}
    )
    return out


def array_length(array):
    helper = LayerHelper("array_length", **locals())
    out = helper.create_tmp_variable(dtype="int64")
    out.stop_gradient = True
    helper.append_op(
        type="array_length", inputs={"X": [array]}, outputs={"Out": [out]}
    )
    return out


class While(object):
    """Counter-bounded loop; the host drives its trips
    (core/kernels_control.py).

    Usage (reference control_flow.py While):
        cond = less_than(counter, limit)
        w = While(cond)
        with w.block():
            ... body ops; must update `cond` via less_than(..., cond=cond)
    """

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("while", name=name)
        if cond.dtype != "bool":
            raise TypeError("While condition must be a bool variable")
        self.cond_var = cond

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent = main.current_block()
        sub = main.create_block()
        try:
            yield
        finally:
            main.rollback()
        # compute the op's outer reads/writes for pruning: names the sub-block
        # reads but does not produce, and names it writes that exist outside
        produced = set()
        reads, writes = [], []
        for op in sub.ops:
            for n in op.input_arg_names:
                if n not in produced and n not in reads:
                    reads.append(n)
            for n in op.output_arg_names:
                produced.add(n)
                outer = parent._find_var_recursive(n)
                if outer is not None and n not in writes:
                    writes.append(n)
        parent.append_op(
            type="while",
            inputs={"Condition": [self.cond_var], "X": reads},
            outputs={"Out": writes},
            attrs={"sub_block": sub.idx},
        )


class DynamicRNN(object):
    """Per-timestep sub-network over a ragged batch (reference
    control_flow.py DynamicRNN, RecurrentGradientMachine in the legacy
    stack). Runs its sub-block once per time step, dense over the whole
    batch (core/kernels_control.py dynamic_rnn)."""

    def __init__(self, name=None):
        self.helper = LayerHelper("dynamic_rnn", name=name)
        self._step_in = []  # (outer_name, inner_name)
        self._static_in = []
        self._mems = []  # dict(init, pre, update, shape, value, dtype)
        self._outputs = []  # (inner_name, outer_var)
        self._sub_idx = None
        self._in_block = False
        self._closed = False

    @contextlib.contextmanager
    def block(self):
        main = self.helper.main_program
        parent = main.current_block()
        sub = main.create_block()
        self._sub_idx = sub.idx
        self._in_block = True
        try:
            yield
        finally:
            self._in_block = False
            main.rollback()
        for m in self._mems:
            if m["update"] is None:
                raise ValueError(
                    "DynamicRNN memory %r was never update_memory()'d" % m["pre"]
                )
        if not self._outputs:
            raise ValueError("DynamicRNN needs at least one output()")
        parent.append_op(
            type="dynamic_rnn",
            inputs={
                "StepIn": [n for n, _ in self._step_in],
                "Static": [n for n, _ in self._static_in],
                "MemInit": [m["init"] for m in self._mems if m["init"]],
            },
            outputs={"Out": [v.name for _, v in self._outputs]},
            attrs={
                "sub_block": sub.idx,
                "step_inner": [i for _, i in self._step_in],
                "static_inner": [i for _, i in self._static_in],
                "mem_pre": [m["pre"] for m in self._mems],
                "mem_update": [m["update"] for m in self._mems],
                "mem_init_names": [m["init"] or "" for m in self._mems],
                "mem_shapes": [m["shape"] or [] for m in self._mems],
                "mem_values": [m["value"] for m in self._mems],
                "mem_dtypes": [m["dtype"] for m in self._mems],
                "out_inner": [i for i, _ in self._outputs],
            },
        )
        self._closed = True

    def _require_in_block(self, what):
        if not self._in_block:
            raise RuntimeError("%s must be called inside rnn.block()" % what)

    def step_input(self, x):
        self._require_in_block("step_input")
        blk = self.helper.main_program.current_block()
        # per-step value is [n_seqs, ...feature dims]: same rank as the
        # packed outer var, the ragged axis becomes the (dynamic) batch
        inner = blk.create_var(
            name=unique_name(x.name + "@step"),
            shape=((-1,) + tuple(x.shape[1:])) if x.shape else None,
            dtype=x.dtype,
        )
        self._step_in.append((x.name, inner.name))
        return inner

    def static_input(self, x):
        self._require_in_block("static_input")
        blk = self.helper.main_program.current_block()
        inner = blk.create_var(
            name=unique_name(x.name + "@static"), shape=x.shape, dtype=x.dtype
        )
        self._static_in.append((x.name, inner.name))
        return inner

    def memory(self, init=None, shape=None, value=0.0, dtype="float32"):
        self._require_in_block("memory")
        blk = self.helper.main_program.current_block()
        if init is not None:
            pre = blk.create_var(
                name=unique_name("mem@pre"), shape=init.shape, dtype=init.dtype
            )
            self._mems.append(
                dict(init=init.name, pre=pre.name, update=None, shape=None,
                     value=0.0, dtype=str(init.dtype))
            )
        else:
            if shape is None:
                raise ValueError("memory() needs init= or shape=")
            # shape is the per-sequence feature shape; the leading dim is
            # the (dynamic) live-sequence batch
            feat = [int(s) for s in shape if int(s) > 0]
            pre = blk.create_var(
                name=unique_name("mem@pre"), shape=(-1,) + tuple(feat), dtype=dtype
            )
            self._mems.append(
                dict(init=None, pre=pre.name, update=None,
                     shape=[int(s) for s in shape], value=float(value),
                     dtype=dtype)
            )
        return pre

    def update_memory(self, ex_mem, new_mem):
        self._require_in_block("update_memory")
        for m in self._mems:
            if m["pre"] == ex_mem.name:
                m["update"] = new_mem.name
                return
        raise ValueError("%r is not a DynamicRNN memory" % ex_mem.name)

    def output(self, *outputs):
        self._require_in_block("output")
        parent = self.helper.main_program.block(
            self.helper.main_program.current_block().parent_idx
        )
        for o in outputs:
            outer = parent.create_var(
                name=unique_name("dynamic_rnn_out"),
                shape=o.shape,
                dtype=o.dtype,
                lod_level=1,
            )
            self._outputs.append((o.name, outer))

    def __call__(self, *args, **kwargs):
        if not self._closed:
            raise RuntimeError("call rnn() after the rnn.block() context ends")
        outs = [v for _, v in self._outputs]
        return outs[0] if len(outs) == 1 else outs


def beam_search(pre_ids, ids, scores, beam_size, end_id, level=0):
    """One beam-search step (reference layers beam_search -> operators/
    beam_search_op.cc; the full-width design in kernels_control)."""
    helper = LayerHelper("beam_search", **locals())
    selected_ids = helper.create_tmp_variable(dtype=ids.dtype)
    selected_scores = helper.create_tmp_variable(dtype=scores.dtype)
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "ids": [ids], "scores": [scores]},
        outputs={
            "selected_ids": [selected_ids],
            "selected_scores": [selected_scores],
        },
        attrs={"beam_size": int(beam_size), "end_id": int(end_id), "level": level},
    )
    return selected_ids, selected_scores


def beam_search_decode(ids, scores, beam_width=0,
                       num_results_per_sample=0):
    """Backtrack completed beams into sentences. Returns (sentence_ids,
    sentence_scores) as padded [n_source*beam, T] arrays; per-row true
    lengths are fetchable via `sentence_ids.lens_name`. When
    0 < num_results_per_sample < beam_width, only each source's top-n
    rows (by cumulative score) are kept."""
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_tmp_variable(dtype=ids.dtype)
    sentence_scores = helper.create_tmp_variable(dtype=scores.dtype)
    lens = helper.create_tmp_variable(dtype="int32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores]},
        outputs={
            "SentenceIds": [sentence_ids],
            "SentenceScores": [sentence_scores],
            "SentenceLens": [lens],
        },
        attrs={
            "beam_width": int(beam_width),
            "num_results_per_sample": int(num_results_per_sample),
        },
    )
    sentence_ids.lens_name = lens.name
    sentence_scores.lens_name = lens.name
    return sentence_ids, sentence_scores


class IfElse(object):
    """Row-wise two-branch conditional (reference control_flow.py IfElse
    + split_lod_tensor/merge_lod_tensor ops). `cond` is an [N, 1] bool;
    inputs are routed into the active branch's rows, both branch bodies
    append row-parallel ops, and outputs merge back into original row
    order.

    Both branches always execute on their routed (compacted,
    zero-padded) buffers — there is no host-side branching;
    `merge_lod_tensor` reassembles by the mask's rank, so branch ops must
    be row-wise (the same contract the reference's scope-per-branch
    execution imposes).

    Usage:
        ie = layers.IfElse(cond)
        with ie.true_block():
            d = ie.input(x)
            ie.output(some_rowwise_fn(d))
        with ie.false_block():
            d = ie.input(x)
            ie.output(other_fn(d))
        (out,) = ie()
    """

    OUT_IF_ELSE_BLOCKS = 2

    def __init__(self, cond, name=None):
        self.helper = LayerHelper("ifelse", name=name)
        self.cond = cond
        self._branch = None  # True / False while inside a block
        self._outs = {True: [], False: []}
        self._splits = {}  # input var name -> (true_rows, false_rows)

    @contextlib.contextmanager
    def _block(self, is_true):
        if self._branch is not None:
            raise RuntimeError("IfElse blocks cannot nest")
        self._branch = is_true
        try:
            yield
        finally:
            self._branch = None

    def true_block(self):
        return self._block(True)

    def false_block(self):
        return self._block(False)

    def input(self, x):
        if self._branch is None:
            raise RuntimeError("IfElse.input() must be called in a block")
        if x.name not in self._splits:
            from . import nn as _nn

            self._splits[x.name] = _nn.split_lod_tensor(x, self.cond)
        t, f = self._splits[x.name]
        return t if self._branch else f

    def output(self, *outs):
        if self._branch is None:
            raise RuntimeError("IfElse.output() must be called in a block")
        self._outs[self._branch].extend(outs)

    def __call__(self):
        if len(self._outs[True]) != len(self._outs[False]):
            raise ValueError(
                "IfElse branches produced %d vs %d outputs"
                % (len(self._outs[True]), len(self._outs[False]))
            )
        from . import nn as _nn

        return [
            _nn.merge_lod_tensor(t, f, t, self.cond)
            for t, f in zip(self._outs[True], self._outs[False])
        ]


class Switch(object):
    """First-true-case-wins conditional assignment (reference
    control_flow.py Switch + conditional_block_op; the learning-rate
    warmup pattern).

    Case bodies may contain any ops; every variable they WRITE that is
    visible outside the Switch becomes a select chain: the value from the
    first case whose scalar condition holds, else the value from
    `default()`, else the variable's prior value. Lowered to `select`
    ops: all branches compute, selection is an elementwise where (the
    reference instead runs one scope-guarded conditional block).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("switch", name=name)
        self._cases = []  # (cond_var or None for default, writes dict)
        self._inside = False
        # select chains are built only for variables that existed BEFORE
        # the switch: those are the assignment targets; vars created
        # inside a case body are case-local temps
        self._preexisting = set(
            self.helper.main_program.current_block().vars
        )

    @contextlib.contextmanager
    def case(self, condition):
        yield from self._capture(condition)

    @contextlib.contextmanager
    def default(self):
        yield from self._capture(None)

    def _capture(self, condition):
        if self._inside:
            raise RuntimeError("Switch cases cannot nest")
        if any(c is None for c, _ in self._cases):
            # reference control_flow.py Switch raises the same way
            raise ValueError("there should be no case after default")
        block = self.helper.main_program.current_block()
        start = len(block.ops)
        self._inside = True
        try:
            yield
        finally:
            self._inside = False
        # redirect every visible write of the case body into a case-local
        # temp; record target -> temp for the select chain. Only reads
        # AFTER the write see the temp — reads before it (e.g.
        # `scale(lr, 0.5)` feeding the `assign` back into lr) must keep
        # reading the prior value.
        writes = {}
        case_ops = block.ops[start:]
        for i, op in enumerate(case_ops):
            for slot, names in op.outputs.items():
                for k, n in enumerate(names):
                    if n not in self._preexisting and not (
                        n not in block.vars
                        and block._find_var_recursive(n) is not None
                    ):
                        # created inside the switch: case-local temp.
                        # Parent-block vars (Switch inside a While body)
                        # are targets even though the current block's own
                        # vars dict never held them.
                        continue
                    tmp = "%s@case%d" % (n, len(self._cases))
                    src = block.var(n)
                    block.create_var(name=tmp, dtype=src.dtype,
                                     shape=src.shape)
                    op.outputs[slot][k] = tmp
                    for later in case_ops[i + 1:]:
                        for islot, inames in later.inputs.items():
                            for j, inn in enumerate(inames):
                                if inn == n:
                                    later.inputs[islot][j] = tmp
                    writes[n] = tmp
        self._cases.append((condition, writes))

    def __exit__(self, *exc):
        if exc and exc[0] is not None:
            return False
        block = self.helper.main_program.current_block()
        targets = []
        for _, writes in self._cases:
            for t in writes:
                if t not in targets:
                    targets.append(t)
        for t in targets:
            # first-true-wins: fold cases right-to-left. EVERY case
            # participates in every target's chain — a case that matched
            # but did not write t pins t to its PRIOR value (the
            # reference executes exactly one conditional block, so later
            # cases must not leak through a matching earlier one).
            current = t  # no case matches -> prior value
            for cond, writes in reversed(self._cases):
                val = writes.get(t, t)
                if cond is None:
                    current = val  # default runs when nothing matched
                    continue
                sel = "%s@sel%d" % (t, len(block.ops))
                block.create_var(name=sel, dtype=block.var(t).dtype,
                                 shape=block.var(t).shape)
                block.append_op(
                    type="select",
                    inputs={"Cond": [cond.name], "X": [val],
                            "Y": [current]},
                    outputs={"Out": [sel]},
                )
                current = sel
            if current != t:
                block.append_op(
                    type="assign", inputs={"X": [current]},
                    outputs={"Out": [t]},
                )
        return False

    def __enter__(self):
        return self


class StaticRNN(object):
    """Fixed-length unrolled RNN builder (reference control_flow.py
    StaticRNN): inputs are [T, ...] time-major dense tensors, the step
    body is captured once and REPLAYED T times at graph-build time with
    step-suffixed variable names (a graph-level unroll; for ragged
    batches use DynamicRNN).
    """

    def __init__(self, name=None):
        self.helper = LayerHelper("static_rnn", name=name)
        self._mems = []      # dict(init_name, pre_name, update_name)
        self._step_in = []   # (outer_name, inner_name)
        self._outs = []      # (inner_name, outer_var)
        self._T = None
        self._ops = None

    @contextlib.contextmanager
    def step(self):
        block = self.helper.main_program.current_block()
        start = len(block.ops)
        yield
        self._ops = block.ops[start:]
        del block.ops[start:]
        self._unroll(block)

    def step_input(self, x):
        if not x.shape or int(x.shape[0]) <= 0:
            raise ValueError(
                "StaticRNN.step_input needs a STATIC time-major leading "
                "dim (got shape %r); declare the data layer with "
                "append_batch_size=False and an explicit T" % (x.shape,)
            )
        T = int(x.shape[0])
        if self._T is None:
            self._T = T
        elif self._T != T:
            raise ValueError("step_input lengths disagree: %d vs %d"
                             % (self._T, T))
        block = self.helper.main_program.current_block()
        inner = self.helper.create_tmp_variable(x.dtype)
        inner.shape = tuple(x.shape[1:])
        self._step_in.append((x.name, inner.name))
        return inner

    def memory(self, init):
        block = self.helper.main_program.current_block()
        pre = self.helper.create_tmp_variable(init.dtype)
        pre.shape = init.shape
        self._mems.append({"init": init.name, "pre": pre.name,
                           "update": None})
        return pre

    def update_memory(self, mem, new):
        for m in self._mems:
            if m["pre"] == mem.name:
                m["update"] = new.name
                return
        raise ValueError("update_memory: unknown memory %r" % mem.name)

    def step_output(self, o):
        outer = self.helper.create_tmp_variable(o.dtype)
        outer.lod_level = 0
        self._outs.append((o.name, outer))

    def output(self, *outputs):
        for o in outputs:
            self.step_output(o)

    def __call__(self):
        outs = [v for _, v in self._outs]
        return outs[0] if len(outs) == 1 else outs

    # ------------------------------------------------------------------
    def _unroll(self, block):
        for m in self._mems:
            if m["update"] is None:
                raise ValueError("StaticRNN memory never update_memory()'d")
        if self._T is None:
            raise ValueError("StaticRNN needs at least one step_input")
        T = self._T

        inner_names = {n for _, n in self._step_in}
        inner_names |= {m["pre"] for m in self._mems}
        for op in self._ops:
            inner_names.update(op.output_arg_names)

        def t_name(n, t):
            return "%s@t%d" % (n, t) if n in inner_names else n

        step_results = {i: [] for i, _ in self._outs}
        for t in range(T):
            # bind step inputs: x[t] (slice keeps a leading 1, squeeze it)
            for outer, inner in self._step_in:
                src = block.var(outer)
                sl = t_name(inner, t) + "@sl"
                block.create_var(name=sl, dtype=src.dtype)
                block.create_var(name=t_name(inner, t), dtype=src.dtype)
                block.append_op(
                    type="slice",
                    inputs={"Input": [outer]},
                    outputs={"Out": [sl]},
                    attrs={"axes": [0], "starts": [t], "ends": [t + 1]},
                )
                block.append_op(
                    type="squeeze",
                    inputs={"X": [sl]},
                    outputs={"Out": [t_name(inner, t)]},
                    attrs={"axes": [0]},
                )
            # bind memories: init at t=0, else previous step's update
            for m in self._mems:
                src = m["init"] if t == 0 else t_name(m["update"], t - 1)
                block.create_var(name=t_name(m["pre"], t), dtype="float32")
                block.append_op(
                    type="assign", inputs={"X": [src]},
                    outputs={"Out": [t_name(m["pre"], t)]},
                )
            # replay body with step-suffixed names
            for op in self._ops:
                inputs = {s: [t_name(n, t) for n in ns]
                          for s, ns in op.inputs.items()}
                outputs = {}
                for s, ns in op.outputs.items():
                    outs = []
                    for n in ns:
                        nn = t_name(n, t)
                        if block._find_var_recursive(nn) is None:
                            v = block.var(n)
                            block.create_var(name=nn, dtype=v.dtype)
                        outs.append(nn)
                    outputs[s] = outs
                block.append_op(type=op.type, inputs=inputs,
                                outputs=outputs, attrs=dict(op.attrs))
            for inner, _ in self._outs:
                step_results[inner].append(t_name(inner, t))

        # stack step outputs to [T, ...]
        for inner, outer in self._outs:
            parts = []
            for t, n in enumerate(step_results[inner]):
                un = n + "@u"
                block.create_var(name=un, dtype="float32")
                block.append_op(
                    type="unsqueeze", inputs={"X": [n]},
                    outputs={"Out": [un]}, attrs={"axes": [0]},
                )
                parts.append(un)
            block.append_op(
                type="concat", inputs={"X": parts},
                outputs={"Out": [outer.name]}, attrs={"axis": 0},
            )


__all__ += ["IfElse", "Switch", "StaticRNN"]
