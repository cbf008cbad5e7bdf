"""mx.contrib (counterpart of ``incubator_mxnet_tpu/contrib/__init__.py``).

Ported so far: ``amp``. The JAX package's other contrib modules (ONNX,
quantization, tensorboard, serving helpers, text, SVRG) are not ported
yet.
"""
from . import amp  # noqa: F401
