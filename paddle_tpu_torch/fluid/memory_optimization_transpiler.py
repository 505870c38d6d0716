"""paddle.v2.fluid.memory_optimization_transpiler (counterpart of
paddle_tpu/fluid/memory_optimization_transpiler.py; reference
memory_optimization_transpiler.py:270 memory_optimize, a liveness
analysis that rewrote variable reuse for the op-at-a-time interpreter).

The port runs a program's ops eagerly and frees each intermediate once
nothing refers to it, so the memory left to win is what autograd keeps
for the backward. Marking a program with `memory_optimize` makes the
lowering run the forward region as checkpointed segments
(core/lowering.py `_run_remat`): only the values at the segments' ends
stay alive, and the backward recomputes one segment at a time. Training
results are those of the unmarked program; only the schedule and the
peak change."""

from __future__ import annotations

__all__ = ["memory_optimize", "release_memory"]


def memory_optimize(input_program, print_log=False, **kwargs):
    """Enable forward-region rematerialization for `input_program`
    (sets `program.remat`, which clone and serialization keep)."""
    input_program.remat = True
    if print_log:
        print("memory_optimize: forward-region rematerialization enabled")
    return input_program


def release_memory(input_program):
    """No-op by design: an intermediate's memory goes back to the
    allocator when its last reference dies."""
    return input_program
