"""trainer_config_helpers/config_parser_utils.py (reference): run a
config FUNCTION (or module path) and return its lowered form. The
reference returned protobufs; here the single source of truth is the
fluid Program, so parsers return the built Topology (main_program /
startup_program attributes) or the recorded optimizer settings."""

from __future__ import annotations

__all__ = [
    "parse_network_config", "parse_optimizer_config",
    "parse_trainer_config", "reset_parser",
]


def reset_parser():
    import paddle_tpu_torch.trainer_config_helpers as tch

    tch.reset_config()


def _run(conf, config_arg_str):
    import paddle_tpu_torch.trainer_config_helpers as tch
    from paddle_tpu_torch.trainer import _parse_config_args

    tch.reset_config(_parse_config_args(config_arg_str or ""))
    conf()
    return tch.get_config_state()


def parse_network_config(network_conf, config_arg_str=""):
    """network_conf: a callable building layers and calling outputs().
    Returns the Topology of the recorded outputs."""
    from paddle_tpu_torch.trainer import resolve_config_outputs
    from paddle_tpu_torch.v2.topology import Topology

    state = _run(network_conf, config_arg_str)
    return Topology(resolve_config_outputs(state))


def parse_optimizer_config(optimizer_conf, config_arg_str=""):
    """optimizer_conf: a callable invoking settings(...). Returns the
    recorded settings dict (learning_method / learning_rate / ...)."""
    state = _run(optimizer_conf, config_arg_str)
    return state["settings"]


def parse_trainer_config(trainer_conf, config_arg_str=""):
    """Whole-config form: returns (Topology, settings)."""
    from paddle_tpu_torch.trainer import resolve_config_outputs
    from paddle_tpu_torch.v2.topology import Topology

    state = _run(trainer_conf, config_arg_str)
    return Topology(resolve_config_outputs(state)), state["settings"]
