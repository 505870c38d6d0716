"""Config parser entry points (reference
python/paddle/trainer/config_parser.py:4350 parse_config — 4.4k LoC of
protobuf assembly driven from an embedded interpreter). Here configs
exec against the trainer_config_helpers DSL and lower to a fluid
Program; parse_config returns that lowered form with the recorded
optimizer settings, and parse_config_and_serialize emits the JSON wire
schema the native runtime loads."""

from __future__ import annotations

import logging
from typing import Any, Dict

__all__ = [
    "logger", "parse_config", "parse_config_and_serialize",
]

logger = logging.getLogger("paddle")
logger.setLevel(logging.INFO)


class ParsedConfig(object):
    """What parse_config returns: the lowered model (Topology with
    main/startup programs) plus the optimizer settings dict — the
    port's equivalents of the reference's ModelConfig/
    OptimizationConfig protobuf pair."""

    def __init__(self, topology, settings):
        self.topology = topology
        self.settings = settings
        # protobuf-era aliases
        self.model_config = topology
        self.opt_config = settings


def parse_config(trainer_config, config_arg_str=""):
    """trainer_config: a config file path (.py/.conf) or a callable.
    config_arg_str: 'key=value,key2=value2' overrides (reference
    get_config_arg)."""
    from paddle_tpu_torch.trainer import (
        _exec_config,
        _parse_config_args,
        resolve_config_outputs,
    )
    from paddle_tpu_torch.v2.topology import Topology
    import paddle_tpu_torch.trainer_config_helpers as tch

    args = _parse_config_args(config_arg_str or "")
    if callable(trainer_config):
        tch.reset_config(args)
        trainer_config()
        state = tch.get_config_state()
    else:
        state = _exec_config(str(trainer_config), args)
    topology = Topology(resolve_config_outputs(state))
    return ParsedConfig(topology, state.get("settings", {}))


def parse_config_and_serialize(trainer_config, config_arg_str=""):
    """The serialized (JSON wire schema) form of the parsed config."""
    from paddle_tpu_torch.fluid.core.serialization import dumps_program

    parsed = parse_config(trainer_config, config_arg_str)
    return dumps_program(parsed.topology.main_program)
