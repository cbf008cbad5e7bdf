"""The ``nd`` namespace: NDArray, its creation functions and the MXNet
operators, each taking NDArrays or tensors (counterpart of
``incubator_mxnet_tpu/ndarray/__init__.py``)."""
from .ndarray import *  # noqa: F401,F403
from .ndarray import NDArray, _apply  # noqa: F401
from .ndarray import slice_op as slice  # noqa: F401  (MXNet's nd.slice)
from . import random  # noqa: F401
from .rnn_op import RNN, rnn_param_size  # noqa: F401
from .ndarray import (sum, max, min, mean, prod, sort, argsort,  # noqa: F401
                      topk, norm, clip, save, load)
