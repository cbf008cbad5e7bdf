"""Engine controls (counterpart of ``incubator_mxnet_tpu/engine.py``;
MXNet's ``python/mxnet/engine.py``).

MXNet's dependency engine groups up to ``bulk_size`` eager operators into
one engine task. The port has no engine of its own: PyTorch launches each
eager ``nd`` operator on the device's current stream as it is called, in
program order, and the paths that are meant to run as one graph already
do (``jit.TrainStep`` and ``HybridBlock.hybridize`` capture a whole step or
forward as one CUDA graph). So ``bulk`` and ``set_bulk_size`` keep MXNet's
API and its value, and change nothing: no operator is held back or
grouped. The initial size is ``MXTPU_ENGINE_BULK_SIZE``.
"""
from __future__ import annotations

import contextlib

__all__ = ["bulk", "set_bulk_size"]

from .config import get_env as _get_env

_BULK_SIZE = [_get_env("MXTPU_ENGINE_BULK_SIZE")]


def set_bulk_size(size):
    """Set the bulk size; returns the previous one."""
    prev = _BULK_SIZE[0]
    _BULK_SIZE[0] = size
    return prev


@contextlib.contextmanager
def bulk(size):
    """The bulk size set to ``size`` inside the block (it groups nothing;
    see the module's docstring)."""
    prev = set_bulk_size(size)
    try:
        yield
    finally:
        set_bulk_size(prev)
