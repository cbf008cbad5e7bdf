"""Gluon: Block, Parameter, nn layers, losses, the Trainer, data loading,
utilities and the contributed blocks and Estimator (``contrib``) over
``torch.nn``."""
from . import data, loss, model_zoo, nn, rnn, utils  # noqa: F401
from . import contrib  # noqa: F401
from .block import Block, HookHandle, HybridBlock, SymbolBlock  # noqa: F401
from .parameter import (Constant, Parameter, ParameterDict,  # noqa: F401
                        DeferredInitializationError)
from .trainer import Trainer  # noqa: F401
from .utils import split_data, split_and_load, clip_global_norm  # noqa: F401
