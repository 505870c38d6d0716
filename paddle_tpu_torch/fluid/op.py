"""Raw operator factory (counterpart of paddle_tpu/fluid/op.py; reference
python/paddle/v2/fluid/op.py).

The reference builds OpDesc protobufs from the C++ OpInfoMap
(get_all_op_protos, OperatorFactory, op.py:19,167); its unit tests use
`Operator("sgd", Param=..., ...)` to make one op outside any layer
helper. Here the registry is the kernel table (core/registry.py), and an
Operator appends to a Block — the same raw-construction surface over
the port's executor.
"""

from __future__ import annotations

from .core.registry import has_kernel, registered_ops

__all__ = ["Operator", "get_all_op_protos"]


def get_all_op_protos():
    """Names of every registered op type (the reference returns OpProto
    messages; the kernel registry is the single source of truth here)."""
    return list(registered_ops())


# Output-slot resolution. The reference resolves a slot's direction from
# the op's OpProto (op.py:19 get_all_op_protos); name existence in the
# block says nothing — in-place ops (sgd ParamOut="w") name an EXISTING
# var as output. Here the conventions of the kernel registry stand in
# for OpProto: in-place update outputs all use the "<Name>Out" suffix
# (ParamOut, MomentOut, VelocityOut, ...), plain "Out" is the canonical
# dense output, and the remaining multi-output ops are tabled explicitly.
_OUTPUT_SLOT_TABLE = {
    # auc reads predictions through a slot literally named "Out"
    # (reference auc_op.cc input slot) — the one "Out"-as-input op.
    "auc": frozenset(["AUC"]),
    "batch_norm": frozenset(
        ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedVariance"]
    ),
    "top_k": frozenset(["Out", "Indices"]),
    "accuracy": frozenset(["Accuracy", "Correct", "Total"]),
    "dropout": frozenset(["Out", "Mask"]),
    "conv2d": frozenset(["Output"]),
    "conv2d_transpose": frozenset(["Output"]),
    "conv3d": frozenset(["Output"]),
    "depthwise_conv2d": frozenset(["Output"]),
}

# slot names that are always outputs when no per-op table entry applies
_GENERIC_OUTPUT_SLOTS = frozenset(["Out", "Output"])


def _is_output_slot(op_type, slot):
    table = _OUTPUT_SLOT_TABLE.get(op_type)
    if table is not None:
        return slot in table
    return slot in _GENERIC_OUTPUT_SLOTS or (
        slot.endswith("Out") and slot != "Out"
    )


class Operator(object):
    """Build one raw op: `Operator("scale", X=["x"], Out=["y"], scale=2.0)`.
    Slot arguments (capitalised, list-or-str of var names) become
    inputs/outputs according to the op's known output slots (falling back
    to block-membership for slots the table doesn't decide); remaining
    kwargs are attributes. Call `append_to(block)` to attach."""

    def __init__(self, type, **kwargs):
        if not has_kernel(type):
            raise ValueError(
                "no kernel registered for op type %r (have %d)"
                % (type, len(registered_ops()))
            )
        self.type = type
        self.slots = {}
        self.attrs = {}
        for k, v in kwargs.items():
            if k[:1].isupper():
                self.slots[k] = [v] if isinstance(v, str) else list(v)
            else:
                self.attrs[k] = v

    def append_to(self, block):
        ins, outs = {}, {}
        for slot, names in self.slots.items():
            if _is_output_slot(self.type, slot):
                # output (possibly in-place onto an existing var — sgd
                # ParamOut names the param itself); create fresh vars on
                # demand
                for n in names:
                    if n not in block.vars:
                        block.create_var(name=n)
                outs[slot] = names
            elif all(n in block.vars for n in names):
                ins[slot] = names
            else:
                # fallback for untabled slots: fresh names are outputs
                for n in names:
                    if n not in block.vars:
                        block.create_var(name=n)
                outs[slot] = names
        return block.append_op(
            type=self.type, inputs=ins, outputs=outs, attrs=self.attrs
        )
