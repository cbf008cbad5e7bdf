"""The legacy symbolic RNN API, ``mx.rnn`` (counterpart of
``incubator_mxnet_tpu/rnn``; MXNet's ``python/mxnet/rnn/``)."""
from .rnn_cell import *  # noqa
from .io import *  # noqa
from .rnn import *  # noqa

from . import rnn_cell, io, rnn  # noqa

__all__ = rnn_cell.__all__ + io.__all__ + rnn.__all__
