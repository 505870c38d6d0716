"""Print the lowered Program of a legacy config (reference
python/paddle/utils/dump_config.py, which printed the TrainerConfig
protobuf).

Usage:
    python -m paddle_tpu_torch.utils.dump_config CONFIG.py [key=value,...]
"""

from __future__ import annotations

import sys

__all__ = ["dump_config"]


def dump_config(config_path, config_args=None):
    """Returns the program-code text of the config's main program."""
    from ..fluid.debugger import program_to_code
    from ..trainer import _exec_config, resolve_config_outputs
    from ..v2.topology import Topology

    state = _exec_config(config_path, config_args or {})
    topo = Topology(resolve_config_outputs(state))
    return program_to_code(topo.main_program)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    from ..trainer import _parse_config_args

    args = _parse_config_args(argv[1]) if len(argv) > 1 else {}
    print(dump_config(argv[0], args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
