"""paddle.v2.networks (reference python/paddle/v2/networks.py): the
composite network helpers, shared with the config DSL
(trainer_config_helpers/networks.py)."""

from ..trainer_config_helpers.networks import *  # noqa: F401,F403
from ..trainer_config_helpers import networks as _n

__all__ = list(_n.__all__)
