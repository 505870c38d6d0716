"""Data-entry layers (reference layers/io.py: data:24) and the pserver
shims ListenAndServ / BlockGuardServ / Send (counterpart of
paddle_tpu/fluid/layers/io.py)."""

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


# ---------------------------------------------------------------------
# pserver-surface shims (reference layers/io.py:102 ListenAndServ, :173
# Send; operators/listen_and_serv_op.cc:56, send_op.cc). Dense
# distributed training here is the mesh executor (the
# DistributeTranspiler maps the pserver topology onto it), so these
# classes keep reference programs importing and building: the optimize
# block recorded under `do()` runs inline in this process, the layout the
# reference's own send_recv_op_test.cc exercises, and `Send` resolves
# against the in-process endpoint registry.
# ---------------------------------------------------------------------

_SERV_REGISTRY = {}  # endpoint -> ListenAndServ


class BlockGuardServ(object):
    """`with serv.do():` - ops appended inside the guard become the
    server's optimize block (reference layers/io.py:30)."""

    def __init__(self, server):
        self.server = server

    def __enter__(self):
        prog = default_main_program()
        self.block = prog.create_block()
        self.server._block = self.block
        return self.block

    def __exit__(self, exc_type, exc_val, exc_tb):
        prog = default_main_program()
        prog.rollback()
        if exc_type is None:
            self.server.complete_op()
        return False


class ListenAndServ(object):
    """Reference layers/io.py:102. Records an optimize block and an
    endpoint; the block's ops are spliced into the parent block, where
    they run with the program (on a mesh, after the executor has summed
    the gradients over the ranks, as the reference's pserver ran them
    after fan-in)."""

    def __init__(self, endpoint, inputs=None, fan_in=1,
                 optimizer_mode=True):
        self.endpoint = endpoint
        self.inputs = list(inputs or [])
        self.fan_in = fan_in
        self.optimizer_mode = optimizer_mode
        self._block = None
        self._params_grads = None  # captured by complete_op

    def do(self):
        return BlockGuardServ(self)

    def get_params_and_grads(self):
        if self._params_grads is not None:
            return self._params_grads
        params, grads = [], []
        if self._block is None:
            return params, grads
        for op in self._block.ops:
            if self.optimizer_mode:
                if "Param" in op.inputs and "Grad" in op.inputs:
                    params.append(op.inputs["Param"][0])
                    grads.append(op.inputs["Grad"][0])
            else:
                # reference layers/io.py:135-139 simple recv mode: every
                # input var lands in BOTH lists
                for names in op.inputs.values():
                    params.extend(names)
                    grads.extend(names)
        return params, grads

    def complete_op(self):
        self._params_grads = self.get_params_and_grads()
        prog = default_main_program()
        parent = prog.global_block()
        for op in self._block.ops:
            parent.ops.append(op)
        for name, var in self._block.vars.items():
            parent.vars.setdefault(name, var)
        self._block.ops = []
        _SERV_REGISTRY[self.endpoint] = self


def Send(endpoints, send_vars, get_vars):
    """Reference layers/io.py:173. In-process: validates the endpoints
    against the registered ListenAndServ instances; the variables already
    live in the scope the spliced optimize block reads."""
    assert isinstance(send_vars, list)
    assert isinstance(get_vars, list)
    epmap = endpoints.split(",")
    unknown = [e for e in set(epmap) if e not in _SERV_REGISTRY]
    if unknown and _SERV_REGISTRY:
        raise ValueError(
            "Send to unregistered endpoint(s) %r; cross-process parameter "
            "service is the mesh executor here, and ListenAndServ/Send "
            "shims only pair up in-process" % unknown)
    return get_vars


__all__ += ["BlockGuardServ", "ListenAndServ", "Send"]
