"""Gluon: Block, Parameter, nn layers, losses and the Trainer over
``torch.nn``."""
from . import loss, nn  # noqa: F401
from .block import Block, HybridBlock  # noqa: F401
from .parameter import (Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .trainer import Trainer  # noqa: F401
