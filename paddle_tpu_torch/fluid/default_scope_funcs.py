"""paddle.v2.fluid.default_scope_funcs (counterpart of
paddle_tpu/fluid/default_scope_funcs.py; reference
default_scope_funcs.py): a thread-default Scope stack with
enter/leave_local_scope, var/find_var, and the scoped_function
decorator — over the port's dict-backed Scope."""

from __future__ import annotations

import threading

from .executor import Scope, global_scope

__all__ = [
    "get_cur_scope", "enter_local_scope", "leave_local_scope", "var",
    "find_var", "scoped_function",
]

_local = threading.local()


def _stack():
    if not hasattr(_local, "stack"):
        _local.stack = [global_scope()]
    return _local.stack


def get_cur_scope() -> Scope:
    return _stack()[-1]


def enter_local_scope():
    _stack().append(Scope())


def leave_local_scope():
    stack = _stack()
    if len(stack) == 1:
        raise RuntimeError("cannot leave the global scope")
    stack.pop()


def var(name):
    """Get-or-create a variable HANDLE in the current scope (reference
    Scope.var returns a Variable whose get_tensor() is settable) —
    delegates to executor.Scope.var's _TensorView."""
    return get_cur_scope().var(name)


def find_var(name):
    """Variable handle, or None when absent anywhere on the stack
    (reference Scope.find_var semantics)."""
    for scope in reversed(_stack()):
        found = scope.find_var(name)
        if found is not None:
            return found
    return None


def scoped_function(func):
    """Run func inside a fresh local scope (reference scoped_function)."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()
