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
from . import linalg, optimizer_ops, sparse  # noqa: F401,E402
from .optimizer_ops import *  # noqa: F401,F403,E402
# MXNet registers each la_op under nd.linalg.<name> and nd.linalg_<name>
for _n in linalg.__all__:
    globals()["linalg_" + _n] = getattr(linalg, _n)
del _n
# the legacy operators (batch_norm_v1.cc, convolution_v1.cc, pooling_v1.cc,
# cudnn_batch_norm.cc) are the modern ones here, as in the JAX package
from .ndarray import BatchNorm as BatchNorm_v1  # noqa: F401,E402
from .ndarray import BatchNorm as CuDNNBatchNorm  # noqa: F401,E402
from .ndarray import Convolution as Convolution_v1  # noqa: F401,E402
from .ndarray import Pooling as Pooling_v1  # noqa: F401,E402


def Custom(*inputs, op_type, **kwargs):
    """A registered custom operator: waits for the port of
    ``operator.py``."""
    raise NotImplementedError("nd.Custom comes with the port of operator.py "
                              "(ROADMAP.md §1 item 6)")


def imdecode(str_img, clip_rect=(0, 0, 0, 0), out=None, index=0, channels=3,
             mean=None, **kw):
    """Decode JPEG/PNG bytes into an HWC uint8 NDArray on the host
    (``image.imdecode``; ``channels`` 1 gives one grey channel)."""
    from ..image import imdecode as _imd
    return _imd(str_img, flag=1 if channels == 3 else 0)
