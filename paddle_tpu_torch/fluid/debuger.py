"""Alias module: the reference package ships this (misspelled) name
(python/paddle/v2/fluid/debuger.py); the implementation lives in
debugger.py."""

from .debugger import *  # noqa: F401,F403
from .debugger import __all__  # noqa: F401
