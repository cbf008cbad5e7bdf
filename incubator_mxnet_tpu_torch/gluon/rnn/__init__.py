"""gluon.rnn (counterpart of ``incubator_mxnet_tpu/gluon/rnn/__init__.py``):
the fused layers and the cells."""
from .rnn_cell import *  # noqa: F401,F403
from .rnn_layer import GRU, LSTM, RNN  # noqa: F401
