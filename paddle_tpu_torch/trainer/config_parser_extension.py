"""Config-parser extension hooks (reference
python/paddle/trainer/config_parser_extension.py): extra data-source
constructors injected into config execution. The reference built
DataConfig protobufs; here a data-source declaration is a plain dict the
trainer's provider loader understands."""

from __future__ import annotations

__all__ = ["SimpleData", "get_config_funcs"]

g_config = None


def SimpleData(files=None, feat_dim=None, context_len=None,
               buffer_capacity=None):
    """Declare a 'simple' file-list data source of flat feature rows."""
    cfg = {
        "type": "simple",
        "files": files,
        "feat_dim": feat_dim,
    }
    if context_len is not None:
        cfg["context_len"] = context_len
    if buffer_capacity:
        cfg["buffer_capacity"] = buffer_capacity
    return cfg


def get_config_funcs(trainer_config):
    global g_config
    g_config = trainer_config
    return dict(SimpleData=SimpleData)
