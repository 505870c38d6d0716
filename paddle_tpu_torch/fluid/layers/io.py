"""Data-entry layers (reference layers/io.py: data:24). The pserver shims
of the JAX package's module (ListenAndServ, Send) are not ported: they
belong to the distribute transpiler, which is not ported yet."""

from __future__ import annotations

from ..core.program import default_main_program

__all__ = ["data"]


def data(
    name,
    shape,
    append_batch_size=True,
    dtype="float32",
    lod_level=0,
    type=None,
    stop_gradient=True,
    **kwargs,
):
    """Declare a feed slot. With append_batch_size, -1 is prepended as the
    batch dim (reference layers/io.py data)."""
    helper_shape = list(shape)
    if append_batch_size:
        helper_shape = [-1] + helper_shape
    main = kwargs.get("main_program") or default_main_program()
    var = main.global_block().create_var(
        name=name,
        shape=helper_shape,
        dtype=dtype,
        lod_level=lod_level,
        stop_gradient=stop_gradient,
        is_data=True,
    )
    return var
