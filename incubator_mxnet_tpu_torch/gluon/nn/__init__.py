"""Gluon nn layers."""
from ..block import Block, HybridBlock, SymbolBlock  # noqa: F401
from .basic_layers import *  # noqa: F401,F403
from .conv_layers import *  # noqa: F401,F403
