"""paddle.v2.fluid.distribute_transpiler_simple (reference
distribute_transpiler_simple.py:65 SimpleDistributeTranspiler, the
unsplit whole-variable pserver transpile; counterpart of
paddle_tpu/fluid/distribute_transpiler_simple.py). Both transpiles run
as mesh data parallelism (distribute_transpiler.py)."""

from .distribute_transpiler import SimpleDistributeTranspiler

__all__ = ["SimpleDistributeTranspiler"]
