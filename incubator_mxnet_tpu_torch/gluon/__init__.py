"""Gluon: Block, Parameter and nn layers over ``torch.nn``."""
from . import nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
