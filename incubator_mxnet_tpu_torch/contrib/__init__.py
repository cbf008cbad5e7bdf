"""mx.contrib (counterpart of ``incubator_mxnet_tpu/contrib/__init__.py``).

Ported so far: ``amp`` and ``serving`` (deployment artifacts). The JAX
package's other contrib modules (ONNX, quantization, tensorboard, text,
SVRG) are ROADMAP §1 item 6.
"""
from . import amp  # noqa: F401
from . import serving  # noqa: F401
