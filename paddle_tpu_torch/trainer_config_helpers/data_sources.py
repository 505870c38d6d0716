"""Data source declaration as a module (reference
trainer_config_helpers/data_sources.py)."""

from . import define_py_data_sources2  # noqa: F401

__all__ = ["define_py_data_sources2"]
