"""paddle.trainer.recurrent_units (reference
python/paddle/trainer/recurrent_units.py): the pre-DSL LSTM/GRU
recurrent-unit helpers some legacy configs import. Each delegates to
the modern composite helpers (trainer_config_helpers/networks.py),
which build the identical step graph (input+recurrent projection, step
layer, state memory via get_output_layer)."""

from __future__ import annotations

from ..trainer_config_helpers import (
    LinearActivation,
    ParamAttr,
    SigmoidActivation,
    TanhActivation,
    networks,
)

__all__ = [
    "LstmRecurrentUnit", "LstmRecurrentUnitNaive",
    "LstmRecurrentLayerGroup",
    "GatedRecurrentUnit", "GatedRecurrentUnitNaive",
    "GatedRecurrentLayerGroup",
]

_ACTS = {
    "tanh": TanhActivation,
    "sigmoid": SigmoidActivation,
    "linear": LinearActivation,
    "": LinearActivation,
    None: LinearActivation,
}


def _act(name):
    if not isinstance(name, (str, type(None))):
        return name  # already an activation object
    try:
        return _ACTS[name]()
    except KeyError:
        raise ValueError("unknown active_type %r" % (name,))


def _one_input(inputs):
    ins = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if len(ins) != 1:
        raise NotImplementedError(
            "recurrent_units helpers here take ONE input layer (the "
            "reference's projection lists pre-date mixed_layer; project "
            "and sum inputs beforehand)"
        )
    return ins[0]


def LstmRecurrentUnit(name, size, active_type, state_active_type,
                      gate_active_type, inputs, para_prefix=None,
                      error_clipping_threshold=0, out_memory=None):
    """One LSTM step (use inside a recurrent_group step function)."""
    return networks.lstmemory_unit(
        input=_one_input(inputs), out_memory=out_memory, name=name,
        size=size, act=_act(active_type), gate_act=_act(gate_active_type),
        state_act=_act(state_active_type),
        param_attr=ParamAttr(name=(para_prefix or name) + "_w"),
    )


LstmRecurrentUnitNaive = LstmRecurrentUnit


def LstmRecurrentLayerGroup(name, size, active_type, state_active_type,
                            gate_active_type, inputs, para_prefix=None,
                            error_clipping_threshold=0, seq_reversed=False):
    """LSTM over a sequence (recurrent_group form)."""
    return networks.lstmemory_group(
        input=_one_input(inputs), size=size, name=name,
        reverse=seq_reversed, act=_act(active_type),
        gate_act=_act(gate_active_type),
        state_act=_act(state_active_type),
        param_attr=ParamAttr(name=(para_prefix or name) + "_w"),
    )


def GatedRecurrentUnit(name, size, active_type, gate_active_type, inputs,
                       para_prefix=None, error_clipping_threshold=0,
                       out_memory=None):
    """One GRU step (use inside a recurrent_group step function); the
    input must already be the 3*size projection, like the reference's
    mixed input_proj."""
    return networks.gru_unit(
        input=_one_input(inputs), memory_boot=out_memory, size=size,
        name=name, act=_act(active_type),
        gate_act=_act(gate_active_type),
        gru_param_attr=ParamAttr(name=(para_prefix or name) + "_w"),
    )


GatedRecurrentUnitNaive = GatedRecurrentUnit


def GatedRecurrentLayerGroup(name, size, active_type, gate_active_type,
                             inputs, para_prefix=None,
                             error_clipping_threshold=0,
                             seq_reversed=False):
    """GRU over a sequence (recurrent_group form); input is the 3*size
    projection sequence."""
    return networks.gru_group(
        input=_one_input(inputs), size=size, name=name,
        reverse=seq_reversed, act=_act(active_type),
        gate_act=_act(gate_active_type),
        gru_param_attr=ParamAttr(name=(para_prefix or name) + "_w"),
    )
