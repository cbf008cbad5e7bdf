"""mx.contrib (counterpart of ``incubator_mxnet_tpu/contrib/__init__.py``).

Ported so far: ``amp``, ``serving`` (deployment artifacts), ``svrg``
(``SVRGModule``) and ``tensorboard`` (``LogMetricsCallback``). The JAX
package's other contrib modules (ONNX, quantization, text) are ROADMAP §1
item 6.
"""
from . import amp  # noqa: F401
from . import serving  # noqa: F401
from . import svrg  # noqa: F401
from . import tensorboard  # noqa: F401
