"""Run a Block's ops on the executor's device (counterpart of
paddle_tpu/fluid/core/lowering.py).

The JAX package traces a block under `jax.jit` and takes its backward as
one `jax.vjp` over the ops before the `autodiff` marker. The port runs
the same three regions eagerly, op by op, on the executor's device:

1. the forward region (the ops before the marker) under autograd, with
   the dense trainable parameters as f32 leaves. Under `program.amp` the
   region reads a bf16 cast of every f32 value it takes in (feeds,
   parameters, batch-norm state), as the JAX package casts only what the
   forward reads, and the deny-listed ops (`_AMP_F32_OPS`) compute in f32
   exactly as its `_run_op_f32` does. Casts are explicit: torch.autocast's
   op lists are not the JAX package's;
2. the gradients: one `torch.autograd.grad` of the loss (in f32) over the
   leaves, bound to the `@GRAD` names (f32, since the leaves are);
3. the tail ops (regularizers, clipping, optimizer updates) under
   torch.no_grad(); the optimizer kernels update the scope's tensors in
   place (kernels_optim.py).

Sparse gradients (`embedding(is_sparse=True)`, `_find_sparse_sites`): a
qualifying table is no leaf of step 1; each of its lookups adds a zero
[n_ids, dim] leaf to its gathered rows instead, so step 2 yields the
rows' gradients and never a [vocab, dim] one, and the table's `@GRAD`
is a SelectedRows of the touched rows (selected_rows.py) that the
optimizer applies to those rows only.

`program.remat` (`memory_optimize`): the forward region runs as about
sqrt(n) segments of its n ops, each under `torch.utils.checkpoint`
(non-reentrant), so only the values that cross a segment's end stay
alive and the backward recomputes one segment at a time (`_run_remat`;
the JAX package wraps the whole region in `jax.checkpoint`). A
recompute repeats no side effect: random ops draw the same keys (the
segment's RNG counter is rewound), `Print` and the While statistics
stay quiet (`LoweringContext.recomputing`), and the values the forward
wrote (batch-norm running statistics, side-bands) are the first pass's.
A region with tensor arrays or control flow, whose host-held arrays
change in place, is one segment.

A program without the marker (startup, inference) runs all its ops under
torch.no_grad(). The forward and tail regions of a training run are
`torch.profiler.record_function` ranges ("fluid/forward",
"fluid/optimizer"): a profiler window attributes the device time of each
(chip_smoke.py --profile; autograd's own thread launches the backward's
kernels, so a range around it would hold none); with no profiler active
a range costs a few microseconds of host time per run.

On a mesh (`spmd`, core/spmd.py) the same regions run on this rank's
shard of the batch: split values carry marks as side-bands do, a
parameter with a spec is read gathered, the loss's backward is seeded
with 1/ranks, and the gradients are summed over the ranks (in buckets)
before the tail runs on this rank's shards.

LoD: ragged values carry their offsets as `x@LOD0` side-bands in the
environment (registry.LoweringContext). After each op, `_share_lod`
hands the first ragged input's offsets to every output that set none,
as the JAX package does; a run with no side-band skips it at once.
"""

from __future__ import annotations

import contextlib
import math
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from .kernels_control import TensorArray, place_hosted
from .kernels_sequence import LOD_SUFFIX, PAD_STRIDE, lod_key
from .registry import LoweringContext, get_kernel
from .selected_rows import SelectedRows

AUTODIFF_OP = "autodiff"
# ops handled by the executor itself, not kernels
_SKIP_OPS = frozenset(["feed", "fetch"])

# AMP f32 deny-list (the JAX package's lowering.py:47-69): numerically
# sensitive ops compute in f32 even inside the bf16 forward region. Float
# inputs are upcast, float outputs downcast back to bf16 so the region
# stays bf16 — except the loss-head ops of _AMP_F32_STICKY, whose outputs
# stay f32. The normalisation layers compute their STATISTICS in f32
# inside their kernels instead (kernels_nn.py).
_AMP_F32_OPS = frozenset(
    [
        "softmax", "log_softmax", "sequence_softmax",
        "cross_entropy", "softmax_with_cross_entropy",
        "sigmoid_cross_entropy_with_logits",
        "mean", "reduce_mean", "reduce_sum",
        "exp", "log",
        "warpctc", "linear_chain_crf", "nce", "hsigmoid",
    ]
)
_AMP_F32_STICKY = frozenset(
    [
        "cross_entropy", "softmax_with_cross_entropy",
        "sigmoid_cross_entropy_with_logits",
        "mean", "reduce_mean", "reduce_sum",
        "warpctc", "linear_chain_crf", "nce", "hsigmoid",
    ]
)


# ops that read env directly (tensor arrays, sub-blocks): inputs may be
# names with no env binding yet (e.g. the first array_write of an array)
# (the JAX package's lowering.py:73-90)
_ENV_OPS = frozenset(
    ["while", "array_write", "array_read", "array_length", "dynamic_rnn",
     "beam_search_decode"]
)


def run_op(ctx: LoweringContext, op, env: Dict[str, Any]):
    """Execute one op: gather named inputs from env, call the kernel, bind
    named outputs back into env."""
    kernel = get_kernel(op.type)
    if ctx.spmd is not None:
        ctx.spmd.globalize(op, env, ctx.block.program)
    ins = {}
    lazy = op.type in _ENV_OPS
    for slot, names in op.inputs.items():
        if lazy:
            ins[slot] = [env.get(n) for n in names]
            continue
        try:
            ins[slot] = [env[n] for n in names]
        except KeyError as e:
            raise RuntimeError(
                "op %r input %s=%r is not available: variable %r was "
                "neither fed nor produced by an earlier op. Common cause:"
                " fetching predictions from the TRAINING program without "
                "feeding labels — optimizer ops keep the loss subgraph "
                "alive; clone(for_test=True) BEFORE optimizer.minimize() "
                "and run the clone instead." % (op.type, slot, names,
                                                e.args[0])
            ) from e
    hosted = ctx.host_names
    if hosted:
        place_hosted(ctx, op, ins, hosted)
    # sequence kernels read LoD offsets / write output LoD via ctx.env
    ctx.op = op
    ctx.env = env
    outs = kernel(ctx, ins, op.attrs)
    for slot, names in op.outputs.items():
        if slot not in outs:
            continue
        vals = outs[slot]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for name, val in zip(names, vals):
            # honor Variable.stop_gradient (reference backward prunes
            # grad flow at such vars): frozen feature extractors really
            # receive no gradient
            var = ctx.block._find_var_recursive(name)
            if var is not None and var.stop_gradient and isinstance(
                    val, torch.Tensor) and val.requires_grad:
                val = val.detach()
            env[name] = val
    _share_lod(ctx, op, env)
    if ctx.spmd is not None:
        ctx.spmd.propagate(op, env)


# ops whose outputs are dense even when inputs are ragged (the JAX
# package's lowering.py:139-156)
_LOD_BARRIER_OPS = frozenset(
    [
        "sequence_pool", "mean", "accuracy", "auc", "top_k",
        "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
        "reduce_prod", "fill_constant_batch_size_like", "shape",
        "isfinite", "squared_l2_norm",
    ]
)


def _share_lod(ctx, op, env):
    """Default LoD propagation (reference: ShareLoD in each op's
    InferShape): row-wise ops keep their input's raggedness, so any
    output that hasn't set its own @LOD0 inherits the first input's.
    Sequence kernels that compute a new LoD set it before this runs;
    reductions that collapse the ragged (row) axis are barriers — a
    reduce over FEATURE axes only (dim excludes 0, no reduce_all) stays
    row-wise and propagates. The offsets tensor itself is shared, so its
    host copy (if any) follows it."""
    if not ctx.has_lod:
        return
    if op.type in _LOD_BARRIER_OPS:
        if not op.type.startswith("reduce_"):
            return
        dims = op.attrs.get("dim", 0)
        dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
        # negative dims can address the row axis without containing 0
        # (dim=-2 on 2-D); rank is unknown here, so treat any negative
        # dim conservatively as a barrier
        if op.attrs.get("reduce_all", False) or 0 in dims or any(
                d < 0 for d in dims):
            return
    src = None
    for names in op.inputs.values():
        for n in names:
            if isinstance(env.get(n), TensorArray):
                continue  # an array's items carry their own side-bands
            src = env.get(lod_key(n))
            if src is not None:
                break
        if src is not None:
            break
    if src is None:
        return
    for names in op.outputs.values():
        for n in names:
            if not isinstance(env.get(n), TensorArray):
                env.setdefault(lod_key(n), src)


def _run_op_f32(ctx: LoweringContext, op, env: Dict[str, Any]):
    """Run one deny-listed op in f32 inside a bf16 region: upcast bf16
    float inputs, run, downcast float outputs back to bf16 (not for the
    sticky loss-head ops)."""
    # gather first: the split values saved for the casts are put back
    if ctx.spmd is not None:
        ctx.spmd.globalize(op, env, ctx.block.program)
    saved = {}
    for names in op.inputs.values():
        for n in names:
            v = env.get(n)
            if isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16:
                saved[n] = v
                env[n] = v.float()
    run_op(ctx, op, env)
    env.update(saved)  # inputs keep their bf16 values for other readers
    if op.type in _AMP_F32_STICKY:
        return
    for names in op.outputs.values():
        for n in names:
            v = env.get(n)
            if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                env[n] = v.to(torch.bfloat16)


def run_ops(ctx: LoweringContext, ops, env: Dict[str, Any]):
    timer = ctx.op_timer
    for op in ops:
        if op.type in _SKIP_OPS:
            continue
        if op.type == AUTODIFF_OP:
            raise RuntimeError(
                "autodiff op reached sequential execution; programs with "
                "append_backward must run through run_block")
        run = _run_op_f32 if ctx.amp_region and op.type in _AMP_F32_OPS \
            else run_op
        if timer is None:
            run(ctx, op, env)
        else:
            with timer(op.type, op, env):
                run(ctx, op, env)


def _split_at_autodiff(ops) -> Tuple[list, Optional[Any], list]:
    for i, op in enumerate(ops):
        if op.type == AUTODIFF_OP:
            return list(ops[:i]), op, list(ops[i + 1:])
    return list(ops), None, []


def _backward_slice(block, fetch_names, persist_names):
    """Keep only ops that (transitively) contribute to a fetch or write a
    persistable (the reference's Prune pass, framework/prune.cc): a
    for_test clone fetched only for predictions never runs its
    label-dependent loss ops."""
    needed = set(fetch_names)
    kept = []
    for op in reversed(block.ops):
        out_names = set(op.output_arg_names)
        if op.type == AUTODIFF_OP:
            out_names |= set(op.attrs.get("grad_names", []))
        if out_names & needed or out_names & persist_names:
            kept.append(op)
            needed |= set(op.input_arg_names)
            if op.type == AUTODIFF_OP:
                needed.add(op.attrs["loss_name"])
                needed |= set(op.attrs.get("param_names", []))
    return list(reversed(kept))


# optimizer ops with a SelectedRows branch (kernels_optim.py; reference
# operators/sgd_op.cc, adam_op.h, adagrad_op.h, momentum). A gradient
# may stay sparse only if EVERY tail op that reads it is one of these.
_SPARSE_OPT_OPS = frozenset(["sgd", "momentum", "adagrad", "adam"])


def _find_sparse_sites(fwd_ops, tail_ops, param_names, grad_names, env):
    """The parameters whose gradient flows as a SelectedRows instead of
    a dense [vocab, dim] tensor (the JAX package's lowering.py:251-292).
    A parameter qualifies when every forward reader is an is_sparse
    `lookup_table` whose Ids are fed or persisted (their shape sizes the
    site's gradient leaf), and every tail op that reads its gradient
    has a sparse update branch (_SPARSE_OPT_OPS). Anything else (a
    dense reader, a regularizer's or clip's op on the gradient, another
    optimizer) takes the exact dense path.

    Returns {param name: [(lookup output name, Ids name) per site]}."""
    pset = set(param_names)
    readers: Dict[str, list] = {}
    for op in fwd_ops:
        for names in op.inputs.values():
            for n in names:
                if n in pset:
                    readers.setdefault(n, []).append(op)
    sites = {}
    for p in param_names:
        ops_r = readers.get(p, [])
        if not ops_r or not all(
                op.type == "lookup_table"
                and op.attrs.get("is_sparse", False)
                and op.inputs.get("W") == [p]
                and all(i in env for i in op.inputs.get("Ids", []))
                for op in ops_r):
            continue
        gname = grad_names[p]
        consumers = [o for o in tail_ops if gname in o.input_arg_names]
        if not consumers or any(o.type not in _SPARSE_OPT_OPS
                                for o in consumers):
            continue
        sites[p] = [(op.outputs["Out"][0], op.inputs["Ids"][0])
                    for op in ops_r]
    return sites


def run_block(block, ops, env: Dict[str, Any], device, base_key=None,
              is_test: bool = False, keep=(), host_lods=None,
              op_timer=None, spmd=None) -> Dict[str, Any]:
    """Run `ops` of `block` over `env` (feeds and persistables by name)
    and return the final environment. `keep` names the values the caller
    reads afterwards besides the persistables (the fetches): the forward
    region's other intermediates are dropped before the backward pass so
    autograd can free them as it goes. `host_lods` maps each fed
    side-band of `env` ("x@LOD0") to its host copy. `op_timer` (the
    profiler's, fluid/profiler.py) times each op of the forward region
    and the backward with the tail as one row. `spmd` (core/spmd.py) is
    the run's view of a mesh: parameters with a spec are read gathered,
    the loss's backward is seeded for the mesh, and the gradients are
    summed over the ranks before the tail runs."""
    host_lods = host_lods or {}
    lengths = [int(np.diff(h).max()) for k, h in host_lods.items()
               if k.endswith(LOD_SUFFIX) and h.shape[0] > 1]
    ctx = LoweringContext(block, base_key, device, is_test=is_test,
                          seq_maxlen=max(lengths) if lengths else None)
    ctx.ops, ctx.keep = ops, keep
    ctx.fetch_names = frozenset(keep)
    ctx.op_timer = op_timer
    ctx.spmd = spmd
    for key, host in host_lods.items():
        ctx.note_host_lod(env[key], host)
        ctx.has_lod = True
    fwd_ops, ad_op, tail_ops = _split_at_autodiff(ops)
    if ad_op is None:
        with torch.no_grad():
            if spmd is None:
                run_ops(ctx, fwd_ops, env)
            else:
                work = dict(env)
                bound = spmd.forward_reads(fwd_ops, work)
                run_ops(ctx, fwd_ops, work)
                # the environment keeps the shards the ops only read
                env.update((k, v) for k, v in work.items()
                           if bound.get(k) is not v)
                spmd.mark_shards(env)
        return env

    loss_name = ad_op.attrs["loss_name"]
    param_names = [p for p in ad_op.attrs["param_names"] if p in env]
    grad_names = dict(zip(ad_op.attrs["param_names"],
                          ad_op.attrs["grad_names"]))
    amp = bool(getattr(block.program, "amp", False))
    # the SelectedRows path: a qualifying table is no autograd leaf; each
    # of its lookups gets a zero [n_ids, dim] leaf instead, whose
    # gradient is the site's value block
    sparse = _find_sparse_sites(fwd_ops, tail_ops, param_names, grad_names,
                                env)
    dense_names = [p for p in param_names if p not in sparse]

    fenv = dict(env)
    if amp:
        # cast ONLY what the forward region reads (feeds, params, BN
        # state) to bf16; optimizer state and scalar accumulators stay
        # f32, and a sparse table is cast row by row after its gather
        for op in fwd_ops:
            for k in op.input_arg_names:
                v = fenv.get(k)
                if isinstance(v, torch.Tensor) and v.dtype == torch.float32 \
                        and k not in sparse:
                    fenv[k] = v.to(torch.bfloat16)
    leaves = {p: env[p].detach().requires_grad_(True) for p in dense_names}
    for p, leaf in leaves.items():
        fenv[p] = (leaf.to(torch.bfloat16)
                   if amp and leaf.dtype == torch.float32 else leaf)
    site_leaf = {}  # lookup output name -> its gradient leaf's name
    for p, sites in sparse.items():
        w = env[p]
        for out, ids in sites:
            name = site_leaf[out] = out + "@sparse_grad"
            leaves[name] = torch.zeros(
                (env[ids].numel(), w.shape[1]), device=w.device,
                dtype=torch.bfloat16 if amp else w.dtype,
                requires_grad=True)
            fenv[name] = leaves[name]
    ctx.sparse_sites = site_leaf
    if spmd is not None:
        spmd.forward_reads(fwd_ops, fenv, sparse)
    live = set(env) | set(keep) | {loss_name}
    live |= {out + "@sparse_rows" for out in site_leaf}
    for op in tail_ops:
        live |= set(op.input_arg_names)
    # a kept ragged value keeps its offsets (and a padded detection
    # buffer its pad stride)
    live |= {lod_key(k) for k in live} | {k + PAD_STRIDE for k in live}
    fenv = _forward_region(ctx, fwd_ops, fenv, live, amp=amp,
                           remat=getattr(block.program, "remat", False))
    loss = fenv[loss_name].float()
    site_rows = {out: fenv[out + "@sparse_rows"] for out in site_leaf}
    ctx.op_timer = None
    with (contextlib.nullcontext() if op_timer is None
          else op_timer(BACKWARD_ROW, None, None)):
        _backward_and_tail(ctx, env, fenv, loss, leaves, dense_names,
                           sparse, site_leaf, site_rows, grad_names,
                           param_names, tail_ops, loss_name)
    return env


# the profiler's row for a training run's backward and optimizer update
BACKWARD_ROW = "backward+update"


def _forward_region(ctx, fwd_ops, fenv, live, amp=False, remat=False):
    """Run the forward region over `fenv` under autograd (checkpointed
    segments when `remat`) and return the environment after it holding
    only the `live` values: the other intermediates are dropped before
    the backward so autograd can free what it saved for them as it
    goes (run_block, run_accum)."""
    ctx.amp_region = amp
    try:
        with torch.enable_grad(), record_function("fluid/forward"):
            if remat:
                fenv = _run_remat(ctx, fwd_ops, fenv, live)
            else:
                run_ops(ctx, fwd_ops, fenv)
    finally:
        ctx.amp_region = False
    return {k: v for k, v in fenv.items() if k in live}


def _loss_grads(loss, leaves, seed: float = 1.0):
    """The gradients of `loss` w.r.t. `leaves`, by leaf name (None for a
    leaf the loss does not reach), the backward seeded with `seed`."""
    if not loss.requires_grad:
        return dict.fromkeys(leaves)
    return dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()),
        grad_outputs=torch.full_like(loss, seed), allow_unused=True)))


def _backward_and_tail(ctx, env, fenv, loss, leaves, dense_names, sparse,
                       site_leaf, site_rows, grad_names, param_names,
                       tail_ops, loss_name=None):
    """The gradients of the forward region's loss bound to their @GRAD
    names in `env` (summed over the mesh's ranks on a mesh), then the
    tail ops under no_grad (run_block)."""
    spmd = ctx.spmd
    seed = 1.0 if spmd is None else spmd.loss_seed(loss_name)
    grads = _loss_grads(loss, leaves, seed)
    # forward-region values win, but the parameters go back to the
    # scope's own f32 tensors (the tail updates those in place)
    originals = {p: env[p] for p in param_names}
    env.clear()
    env.update(fenv)
    env.update(originals)
    dense = {p: grads[p] for p in dense_names if grads[p] is not None}
    if spmd is not None:
        with torch.no_grad(), record_function("fluid/grad_sync"):
            dense = spmd.sync_dense(dense)
    for p in dense_names:
        g = dense.get(p)
        env[grad_names[p]] = g if g is not None \
            else torch.zeros_like(originals[p])
    for p, sites in sparse.items():
        vals = []
        for out, _ in sites:
            g = grads[site_leaf[out]]
            vals.append(g if g is not None
                        else torch.zeros_like(leaves[site_leaf[out]]))
        sr = SelectedRows(
            torch.cat([site_rows[out].reshape(-1) for out, _ in sites]),
            torch.cat(vals).float(), originals[p].shape[0])
        if spmd is not None:
            with torch.no_grad():
                sr = spmd.sync_sparse(p, sr)
        env[grad_names[p]] = sr
    if spmd is not None:
        spmd.mark_shards(env, grad_names)
    with torch.no_grad(), record_function("fluid/optimizer"):
        run_ops(ctx, tail_ops, env)


# ops that keep host-held tensor arrays or run sub-blocks over the
# environment: a checkpoint cut must not fall between an array's writes
# and its reads (an array changes in place, so a recompute would see
# later writes)
_NO_CUT_OPS = _ENV_OPS | frozenset(
    ["lod_tensor_to_array", "array_to_lod_tensor", "shrink_rnn_memory",
     "beam_search", "beam_init"])


def _remat_segments(ops):
    """The forward region cut into about sqrt(len(ops)) runs of ops (one
    run when it holds an op of _NO_CUT_OPS)."""
    if not ops or any(op.type in _NO_CUT_OPS for op in ops):
        return [list(ops)]
    size = math.ceil(len(ops) / max(1, round(math.sqrt(len(ops)))))
    return [list(ops[i:i + size]) for i in range(0, len(ops), size)]


def _is_live(name, names):
    """`name` or the variable whose side-band it is ("x@LOD0" of x)."""
    return name in names or name.partition("@")[0] in names


def _run_remat(ctx, ops, fenv, live):
    """Run the forward region as checkpointed segments (memory_optimize)
    and return the environment after it, holding only the values read
    later (`live` names those read after the region). Each segment runs
    once now and once more in the backward, when autograd first needs a
    value it saved; that second run starts from the RNG counter the
    first one started from and runs with `ctx.recomputing` set."""
    program = ctx.block.program
    segments = _remat_segments(ops)
    after, reads = [], set(live)
    for seg in reversed(segments):
        after.append(set(reads))
        for op in seg:
            reads |= set(op.input_arg_names)
            reads |= program._sub_block_outer_reads(op)
    for seg, later in zip(segments, reversed(after)):
        state = {"start": ctx._rng_counter, "amp": ctx.amp_region,
                 "runs": 0}

        def region(env_in, seg=seg, state=state):
            # the recompute runs in the backward, after the forward has
            # left its AMP region: it re-enters the region's mode
            state["runs"] += 1
            again = state["runs"] > 1
            resume, amp = ctx._rng_counter, ctx.amp_region
            if again:
                ctx._rng_counter = state["start"]
            ctx.recomputing, ctx.amp_region = again, state["amp"]
            local = dict(env_in)
            try:
                run_ops(ctx, seg, local)
            finally:
                ctx.recomputing, ctx.amp_region = False, amp
                if again:
                    ctx._rng_counter = resume
            return local

        out = checkpoint(region, fenv, use_reentrant=False,
                         preserve_rng_state=False)
        fenv = {k: v for k, v in out.items() if _is_live(k, later)}
    return fenv


# shape-only wrappers between a loss and the reduction that makes it
_PASSTHROUGH = ("reshape", "reshape2", "squeeze", "unsqueeze", "cast")


def _warn_if_sum_loss(fwd_ops, loss_name):
    """Chunk gradients are averaged, which is exact only for a
    mean-reduced loss: warn when the loss comes from a batch-axis
    `reduce_sum` (the JAX package's build_accum_step_fn rule; op `sum`
    adds tensors elementwise and stays exact)."""
    producers = {}
    for op in fwd_ops:
        for name in op.output_arg_names:
            producers[name] = op
    op = producers.get(loss_name)
    for _ in range(8):
        if op is None or op.type not in _PASSTHROUGH:
            break
        src = op.input_arg_names
        op = producers.get(src[0]) if src else None
    if op is None or op.type != "reduce_sum":
        return
    dims = op.attrs.get("dim", 0)
    dims = list(dims) if isinstance(dims, (list, tuple)) else [dims]
    if op.attrs.get("reduce_all", False) or 0 in dims or any(
            d < 0 for d in dims):
        warnings.warn(
            "gradient accumulation averages chunk gradients (exact for "
            "mean-reduced losses) but the loss %r is produced by %r — a "
            "SUM reduction trains with gradients scaled by 1/"
            "micro_batches; reduce the loss with mean() instead"
            % (loss_name, op.type), stacklevel=4)


def run_accum(block, ops, env: Dict[str, Any], feeds: Dict[str, Any],
              device, micro_batches: int, base_key, fetch_names=()):
    """ONE optimizer step over `micro_batches` forward/backward passes
    (the JAX package's build_accum_step_fn): each feed splits into equal
    chunks along axis 0; chunk i runs the forward region under autograd
    with its own context on fold_in(base_key, i), and the gradients of
    its loss add up; the tail ops (regularizers, clipping, the optimizer)
    run once, on the mean of the chunk gradients, with a context on
    base_key. Values the forward writes to persistables (batch-norm
    statistics) carry from chunk to chunk, as over K small batches.
    Every gradient is dense (a sparse table's included) and the
    activations of one chunk at a time are alive.

    `env` holds the persistables and is updated in place; returns the
    fetches: the loss as the mean of the chunk losses, or a value the
    tail ops leave in the environment. `base_key` is the run's key on
    the host; each chunk's key goes to the device without a wait."""
    from ...utils import prng
    from .kernels_control import to_device_async

    fwd_ops, ad_op, tail_ops = _split_at_autodiff(ops)
    if ad_op is None:
        raise ValueError("gradient accumulation requires a training "
                         "program (optimizer.minimize before run)")
    loss_name = ad_op.attrs["loss_name"]
    _warn_if_sum_loss(fwd_ops, loss_name)
    k = int(micro_batches)
    chunks = {}
    for n, v in feeds.items():
        if v.shape[0] % k:
            raise ValueError("batch dim %d of feed %r is not divisible by "
                             "micro_batches=%d" % (v.shape[0], n, k))
        chunks[n] = v.reshape((k, v.shape[0] // k) + tuple(v.shape[1:]))
    param_names = [p for p in ad_op.attrs["param_names"] if p in env]
    grad_names = dict(zip(ad_op.attrs["param_names"],
                          ad_op.attrs["grad_names"]))
    gsum = {p: torch.zeros(env[p].shape, dtype=torch.float32,
                           device=env[p].device) for p in param_names}
    live = set(env) | {loss_name}
    for op in tail_ops:
        live |= set(op.input_arg_names)
    live |= {lod_key(n) for n in live} | {n + PAD_STRIDE for n in live}
    losses = []
    for i in range(k):
        ctx = LoweringContext(block, to_device_async(
            prng.fold_in(base_key, i), device), device)
        ctx.ops, ctx.keep = ops, tuple(fetch_names)
        fenv = dict(env)
        fenv.update({n: c[i] for n, c in chunks.items()})
        leaves = {p: env[p].detach().requires_grad_(True)
                  for p in param_names}
        fenv.update(leaves)
        fenv = _forward_region(ctx, fwd_ops, fenv, live)
        loss = fenv[loss_name].float()
        with torch.no_grad():
            for p, g in _loss_grads(loss, leaves).items():
                if g is not None:
                    gsum[p] += g
        losses.append(loss.detach())
        # persistables the forward wrote carry to the next chunk
        for n in env:
            v = fenv.get(n)
            if n not in leaves and isinstance(v, torch.Tensor) \
                    and v is not env[n]:
                env[n] = v.detach().to(env[n].dtype)
    for p in param_names:
        env[grad_names[p]] = gsum[p] / float(k)
    ctx = LoweringContext(block, to_device_async(base_key, device), device)
    ctx.ops, ctx.keep = ops, tuple(fetch_names)
    with torch.no_grad(), record_function("fluid/optimizer"):
        run_ops(ctx, tail_ops, env)
    fetches = []
    for n in fetch_names:
        if n == loss_name:
            # the mean over the chunks keeps the mean op's [1] shape
            fetches.append(torch.stack(losses).mean(0))
        elif n in env:
            fetches.append(env[n])
        else:
            raise KeyError(
                "fetch %r is neither the loss nor a tail-op output; "
                "per-chunk intermediates are not retained under gradient "
                "accumulation" % n)
    return fetches
