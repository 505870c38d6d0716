"""Learning-rate decay schedules as graph ops (a copy of
paddle_tpu/fluid/learning_rate_decay.py; reference
python/paddle/v2/fluid/learning_rate_decay.py: exponential_decay,
natural_exp_decay, inverse_time_decay, polynomial_decay, piecewise_decay).
Each returns a Variable computed from a global_step Variable, fed to
Optimizer(learning_rate=...). The step counter and the schedule's ops
run on the executor's device like any other persistable and op (a
`force_cpu` global step included), so the rate reaches the optimizer
ops as a device tensor with no host read per step."""

from __future__ import annotations

from . import layers

__all__ = [
    "exponential_decay",
    "natural_exp_decay",
    "inverse_time_decay",
    "polynomial_decay",
    "piecewise_decay",
]


def _step_f(global_step):
    return layers.cast(x=global_step, dtype="float32")


def exponential_decay(learning_rate, global_step, decay_steps, decay_rate, staircase=False):
    div = layers.elementwise_div(
        x=_step_f(global_step),
        y=layers.fill_constant(shape=[1], dtype="float32", value=float(decay_steps)),
    )
    if staircase:
        div = layers.floor(x=div)
    pow_v = layers.elementwise_pow(
        x=layers.fill_constant(shape=[1], dtype="float32", value=float(decay_rate)),
        y=div,
    )
    return layers.scale(x=pow_v, scale=float(learning_rate))


def natural_exp_decay(learning_rate, global_step, decay_steps, decay_rate, staircase=False):
    div = layers.elementwise_div(
        x=_step_f(global_step),
        y=layers.fill_constant(shape=[1], dtype="float32", value=float(decay_steps)),
    )
    if staircase:
        div = layers.floor(x=div)
    exp_v = layers.exp(x=layers.scale(x=div, scale=-float(decay_rate)))
    return layers.scale(x=exp_v, scale=float(learning_rate))


def inverse_time_decay(learning_rate, global_step, decay_steps, decay_rate, staircase=False):
    div = layers.elementwise_div(
        x=_step_f(global_step),
        y=layers.fill_constant(shape=[1], dtype="float32", value=float(decay_steps)),
    )
    if staircase:
        div = layers.floor(x=div)
    denom = layers.scale(x=div, scale=float(decay_rate), bias=1.0)
    lr = layers.fill_constant(shape=[1], dtype="float32", value=float(learning_rate))
    return layers.elementwise_div(x=lr, y=denom)


def polynomial_decay(learning_rate, global_step, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    gs = _step_f(global_step)
    ds = layers.fill_constant(shape=[1], dtype="float32", value=float(decay_steps))
    if cycle:
        ratio = layers.ceil(x=layers.elementwise_div(
            x=layers.elementwise_max(
                x=gs, y=layers.fill_constant(shape=[1], dtype="float32", value=1.0)
            ),
            y=ds,
        ))
        ds = layers.elementwise_mul(x=ds, y=ratio)
    else:
        gs = layers.elementwise_min(x=gs, y=ds)
    frac = layers.elementwise_div(x=gs, y=ds)
    one_minus = layers.scale(x=frac, scale=-1.0, bias=1.0)
    poly = layers.elementwise_pow(
        x=one_minus,
        y=layers.fill_constant(shape=[1], dtype="float32", value=float(power)),
    )
    return layers.scale(
        x=poly, scale=float(learning_rate) - float(end_learning_rate),
        bias=float(end_learning_rate),
    )


def piecewise_decay(global_step, boundaries, values):
    """Piecewise-constant schedule: a sum of indicator-masked constants,
    branch-free, so the step never reads the counter back."""
    if len(values) - len(boundaries) != 1:
        raise ValueError("len(values) must be len(boundaries) + 1")
    gs = _step_f(global_step)
    total = None
    prev_bound = None
    for i, v in enumerate(values):
        if i == 0:
            cond = layers.cast(
                x=gs < float(boundaries[0]), dtype="float32"
            )
        elif i == len(values) - 1:
            cond = layers.cast(
                x=gs >= float(boundaries[-1]), dtype="float32"
            )
        else:
            below = layers.cast(x=gs < float(boundaries[i]), dtype="float32")
            at_or_above = layers.cast(x=gs >= float(boundaries[i - 1]), dtype="float32")
            cond = layers.elementwise_mul(x=below, y=at_or_above)
        term = layers.scale(x=cond, scale=float(v))
        total = term if total is None else layers.elementwise_add(x=total, y=term)
    return total
