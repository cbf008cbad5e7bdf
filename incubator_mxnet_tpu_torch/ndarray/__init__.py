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
from . import contrib  # noqa: F401,E402
# MXNet's top-level spatial operators (roi_pooling.cc, bilinear_sampler.cc,
# spatial_transformer.cc), the detection module's functions
from ..ops.detection import (  # noqa: F401,E402
    roi_pooling as ROIPooling,
    bilinear_sampler as BilinearSampler,
    grid_generator as GridGenerator,
    spatial_transformer as SpatialTransformer,
)
