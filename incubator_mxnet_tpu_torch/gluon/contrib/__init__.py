"""gluon.contrib (counterpart of ``incubator_mxnet_tpu/gluon/contrib``):
MXNet's contributed blocks (``nn``, ``cnn``, ``rnn``), datasets and
samplers (``data``) and the ``estimator`` training loop."""
from . import estimator  # noqa: F401
from . import nn  # noqa: F401
from . import cnn  # noqa: F401
from . import data  # noqa: F401
from . import rnn  # noqa: F401
