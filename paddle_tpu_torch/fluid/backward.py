"""append_backward: mark the program for gradient computation.

Reference parity: python/paddle/v2/fluid/backward.py + C++
framework/backward.cc:523 (AppendBackward). The reference appends one grad
op per forward op via a registry of GradOpDescMakers; here we instead
append a single `autodiff` marker op recording (loss, params, grad names).
At run time the marker becomes one `torch.autograd.grad` over the
forward region (core/lowering.py), as the JAX package makes it one
`jax.vjp`: exact, and no grad op per forward op.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .core.lowering import AUTODIFF_OP
from .core.program import Parameter, Program, Variable, grad_var_name

__all__ = ["append_backward", "calc_gradient"]


def append_backward(
    loss: Variable,
    parameter_list: Optional[List[str]] = None,
    no_grad_set=None,
    callbacks=None,
) -> List[Tuple[Variable, Variable]]:
    program = loss.block.program
    block = program.global_block()
    if any(op.type == AUTODIFF_OP for op in block.ops):
        raise ValueError(
            "program already has an autodiff marker (minimize or "
            "calc_gradient); one program supports one backward"
        )

    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p for p in parameter_list]
    else:
        params = [p for p in block.all_parameters() if getattr(p, "trainable", True)]
    no_grad = set()
    if no_grad_set:
        no_grad = {v.name if isinstance(v, Variable) else str(v) for v in no_grad_set}
    params = [p for p in params if p.name not in no_grad]

    params_and_grads: List[Tuple[Variable, Variable]] = []
    grad_names = []
    for p in params:
        g_name = grad_var_name(p.name)
        if g_name in block.vars:
            g = block.vars[g_name]
        else:
            g = block.create_var(
                name=g_name, shape=p.shape, dtype=p.dtype, persistable=False
            )
        g.stop_gradient = True
        params_and_grads.append((p, g))
        grad_names.append(g_name)

    block.append_op(
        type=AUTODIFF_OP,
        inputs={},
        outputs={"Grads": grad_names},
        attrs={
            "loss_name": loss.name,
            "param_names": [p.name for p in params],
            "grad_names": grad_names,
        },
    )
    return params_and_grads


def calc_gradient(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of `targets` w.r.t. arbitrary LEAF variables (feeds or
    parameters) — reference backward.py:464. Lowers to the same single
    autograd pass the training path uses: a scalar <sum of targets (weighted
    by target_gradients)> is built with graph ops, then the autodiff
    marker records the input->grad map.

    Restrictions of the fused-vjp design: inputs must be leaves (a feed
    or parameter; gradients w.r.t. intermediates would require a second
    trace cut), and a program carries at most one autodiff marker —
    call this OR minimize, not both, on the same program.

    Divergence from the reference: for a leaf input that does not affect
    the targets the reference returns None; the fused vjp returns a
    ZEROS array of the leaf's shape (same calculus, different encoding).
    """
    from .core.program import Parameter, unique_name

    def _as_list(x):
        return list(x) if isinstance(x, (list, tuple)) else [x]

    targets = _as_list(targets)
    inputs = _as_list(inputs)
    # eager leaf validation: an intermediate input would silently fall out
    # of the vjp leaf set (lowering keeps only names already bound in the
    # scope/feed env), leaving its grad var unpopulated and failing much
    # later with an opaque fetch KeyError — reject it here instead
    for v in inputs:
        if not (
            isinstance(v, Parameter)
            or getattr(v, "is_data", False)
            or getattr(v, "persistable", False)  # scope-bound leaves
        ):
            raise NotImplementedError(
                "calc_gradient input %r is neither a Parameter nor a "
                "data (feed) variable nor a persistable; gradients "
                "w.r.t. intermediate values are not supported by the "
                "fused-vjp design — take the gradient at the leaves "
                "that produce it" % v.name
            )
    target_gradients = _as_list(target_gradients or [])
    if target_gradients and len(target_gradients) != len(targets):
        raise ValueError(
            "should have the same number of target_gradients as targets"
        )
    block = targets[0].block
    if any(op.type == AUTODIFF_OP for op in block.ops):
        raise ValueError(
            "program already has an autodiff marker (minimize or a "
            "previous calc_gradient); one program supports one backward"
        )
    input_name_set = {v.name for v in inputs}
    no_grad = {
        v.name if isinstance(v, Variable) else str(v)
        for v in (no_grad_set or [])
    }
    beyond = no_grad - input_name_set
    if beyond:
        # the fused vjp differentiates the whole forward region; cutting
        # gradient flow at an INTERMEDIATE would silently change numbers
        raise NotImplementedError(
            "no_grad_set entries that are not calc_gradient inputs are "
            "not supported (would require a stop-gradient cut inside "
            "the fused vjp): %r" % sorted(beyond)
        )

    # scalar objective: sum_i reduce_sum(target_i * tg_i). Ops append to
    # the TARGETS' block directly — layer helpers would write to the
    # current default program, which may be a different one.
    def _tmp(like, shape=None):
        return block.create_var(
            name=unique_name("calc_grad_obj"),
            shape=list(shape if shape is not None else like.shape or []),
            dtype=like.dtype,
        )

    parts = []
    for i, t in enumerate(targets):
        tg = target_gradients[i] if target_gradients else None
        term = t
        if tg is not None:
            term = _tmp(t)
            block.append_op(
                type="elementwise_mul", inputs={"X": [t], "Y": [tg]},
                outputs={"Out": [term]}, attrs={},
            )
        part = _tmp(t, shape=[1])
        block.append_op(
            type="reduce_sum", inputs={"X": [term]},
            outputs={"Out": [part]}, attrs={"reduce_all": True},
        )
        parts.append(part)
    total = parts[0]
    for p in parts[1:]:
        nxt = _tmp(total, shape=[1])
        block.append_op(
            type="elementwise_add", inputs={"X": [total], "Y": [p]},
            outputs={"Out": [nxt]}, attrs={},
        )
        total = nxt

    grads = []
    grad_names, input_names = [], []
    for v in inputs:
        if v.name in no_grad:
            grads.append(None)
            continue
        g_name = grad_var_name(v.name)
        g = block.create_var(
            name=g_name, shape=v.shape, dtype=v.dtype, persistable=False
        )
        g.stop_gradient = True
        grads.append(g)
        grad_names.append(g_name)
        input_names.append(v.name)

    block.append_op(
        type=AUTODIFF_OP,
        inputs={},
        outputs={"Grads": grad_names},
        attrs={
            "loss_name": total.name,
            "param_names": input_names,
            "grad_names": grad_names,
        },
    )
    return grads
