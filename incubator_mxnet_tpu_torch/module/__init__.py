"""The ``mx.mod`` namespace (counterpart of
``incubator_mxnet_tpu/module``): the symbolic trainers."""
from .base_module import BaseModule  # noqa
from .module import Module  # noqa
from .bucketing_module import BucketingModule  # noqa
from .sequential_module import SequentialModule  # noqa
