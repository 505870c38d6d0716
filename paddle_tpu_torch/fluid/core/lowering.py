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

A program without the marker (startup, inference) runs all its ops under
torch.no_grad(). The forward and tail regions of a training run are
`torch.profiler.record_function` ranges ("fluid/forward",
"fluid/optimizer"): a profiler window attributes the device time of each
(chip_smoke.py --profile; autograd's own thread launches the backward's
kernels, so a range around it would hold none); with no profiler active
a range costs a few microseconds of host time per run.

LoD: ragged values carry their offsets as `x@LOD0` side-bands in the
environment (registry.LoweringContext). After each op, `_share_lod`
hands the first ragged input's offsets to every output that set none,
as the JAX package does; a run with no side-band skips it at once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from .kernels_control import TensorArray, place_hosted
from .kernels_sequence import LOD_SUFFIX, lod_key
from .registry import LoweringContext, get_kernel

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
    for op in ops:
        if op.type in _SKIP_OPS:
            continue
        if op.type == AUTODIFF_OP:
            raise RuntimeError(
                "autodiff op reached sequential execution; programs with "
                "append_backward must run through run_block")
        if ctx.amp_region and op.type in _AMP_F32_OPS:
            _run_op_f32(ctx, op, env)
        else:
            run_op(ctx, op, env)


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


def _refuse_sparse(fwd_ops):
    """The JAX package gives an `is_sparse` embedding a SelectedRows
    gradient (lazy optimizer updates on the touched rows only); the
    port's dense gradient would update differently, so it refuses."""
    for op in fwd_ops:
        if op.type == "lookup_table" and op.attrs.get("is_sparse", False):
            raise NotImplementedError(
                "embedding(is_sparse=True) trains through SelectedRows "
                "gradients, which are not ported yet (ROADMAP Queue A, "
                "Fluid); build the embedding with is_sparse=False")


def run_block(block, ops, env: Dict[str, Any], device, base_key=None,
              is_test: bool = False, keep=(), host_lods=None
              ) -> Dict[str, Any]:
    """Run `ops` of `block` over `env` (feeds and persistables by name)
    and return the final environment. `keep` names the values the caller
    reads afterwards besides the persistables (the fetches): the forward
    region's other intermediates are dropped before the backward pass so
    autograd can free them as it goes. `host_lods` maps each fed
    side-band of `env` ("x@LOD0") to its host copy."""
    host_lods = host_lods or {}
    lengths = [int(np.diff(h).max()) for k, h in host_lods.items()
               if k.endswith(LOD_SUFFIX) and h.shape[0] > 1]
    ctx = LoweringContext(block, base_key, device, is_test=is_test,
                          seq_maxlen=max(lengths) if lengths else None)
    ctx.ops, ctx.keep = ops, keep
    ctx.fetch_names = frozenset(keep)
    for key, host in host_lods.items():
        ctx.note_host_lod(env[key], host)
        ctx.has_lod = True
    fwd_ops, ad_op, tail_ops = _split_at_autodiff(ops)
    if ad_op is None:
        with torch.no_grad():
            run_ops(ctx, fwd_ops, env)
        return env
    _refuse_sparse(fwd_ops)

    loss_name = ad_op.attrs["loss_name"]
    param_names = [p for p in ad_op.attrs["param_names"] if p in env]
    grad_names = dict(zip(ad_op.attrs["param_names"],
                          ad_op.attrs["grad_names"]))
    amp = bool(getattr(block.program, "amp", False))

    fenv = dict(env)
    if amp:
        # cast ONLY what the forward region reads (feeds, params, BN
        # state) to bf16; optimizer state and scalar accumulators stay f32
        for op in fwd_ops:
            for k in op.input_arg_names:
                v = fenv.get(k)
                if isinstance(v, torch.Tensor) and v.dtype == torch.float32:
                    fenv[k] = v.to(torch.bfloat16)
    leaves = {p: env[p].detach().requires_grad_(True) for p in param_names}
    for p, leaf in leaves.items():
        fenv[p] = (leaf.to(torch.bfloat16)
                   if amp and leaf.dtype == torch.float32 else leaf)
    ctx.amp_region = amp
    try:
        with torch.enable_grad(), record_function("fluid/forward"):
            run_ops(ctx, fwd_ops, fenv)
    finally:
        ctx.amp_region = False
    loss = fenv[loss_name].float()

    live = set(env) | set(keep)
    for op in tail_ops:
        live |= set(op.input_arg_names)
    # a kept ragged value keeps its offsets
    live |= {lod_key(k) for k in live}
    fenv = {k: v for k, v in fenv.items() if k in live}
    if loss.requires_grad:
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    grad_outputs=torch.ones_like(loss),
                                    allow_unused=True)
    else:
        grads = [None] * len(leaves)

    # forward-region values win, but the parameters go back to the
    # scope's own f32 tensors (the tail updates those in place)
    originals = {p: env[p] for p in param_names}
    env.clear()
    env.update(fenv)
    env.update(originals)
    for p, g in zip(param_names, grads):
        env[grad_names[p]] = (g if g is not None
                              else torch.zeros_like(originals[p]))
    with torch.no_grad(), record_function("fluid/optimizer"):
        run_ops(ctx, tail_ops, env)
    return env
