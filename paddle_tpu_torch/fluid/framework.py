"""fluid.framework: re-export of the IR object model.

Mirrors reference python/paddle/v2/fluid/framework.py so user code doing
`from paddle.v2.fluid.framework import Program, program_guard` ports by
changing only the package root.
"""

from .core.program import (  # noqa: F401
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    convert_np_dtype,
    default_main_program,
    default_startup_program,
    grad_var_name,
    program_guard,
    switch_main_program,
    switch_startup_program,
    unique_name,
)


def get_var(name, program=None):
    if program is None:
        program = default_main_program()
    return program.global_block().var(name)
