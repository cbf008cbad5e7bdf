"""Optimizer API (counterpart of ``incubator_mxnet_tpu/optimizer``)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import Optimizer, create, register  # noqa: F401
