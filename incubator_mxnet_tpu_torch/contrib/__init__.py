"""mx.contrib (counterpart of ``incubator_mxnet_tpu/contrib/__init__.py``):
``amp``, ``quantization`` (int8), ``tensorboard``, ``onnx`` (with its
codec ``onnx_proto``), ``serving`` (deployment artifacts), ``text`` and
``svrg`` (``SVRGModule``).
"""
from . import amp  # noqa: F401
from . import quantization  # noqa: F401
from . import tensorboard  # noqa: F401
from . import onnx  # noqa: F401
from . import serving  # noqa: F401
from . import text  # noqa: F401
from . import svrg  # noqa: F401
