"""Gluon nn layers."""
from .basic_layers import *  # noqa: F401,F403
