"""Device context (counterpart of ``incubator_mxnet_tpu/context.py``).

``gpu(i)`` is the first-class context and denotes ``torch.device("cuda",
i)``; ``tpu(i)`` is kept as a migration alias of ``gpu(i)``. The default
context is ``gpu(0)``. Where CUDA is absent, resolving a GPU context raises:
the port never falls back to the CPU on its own. Pass ``cpu()`` (or enter
``with cpu():``) to run on the CPU.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus"]


class Context:
    """A device context: ``device_type`` in {'cpu', 'gpu'} and an index."""

    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            device_type, device_id = device_type.device_type, device_type.device_id
        if device_type == "tpu":
            device_type = "gpu"
        if device_type not in ("cpu", "gpu"):
            raise ValueError("unknown device_type %r" % (device_type,))
        self.device_type = device_type
        self.device_id = int(device_id)
        self._old_ctx = None

    @property
    def torch_device(self):
        """The ``torch.device`` this context denotes; raises for a GPU
        context when CUDA is absent."""
        if self.device_type == "cpu":
            return torch.device("cpu")
        n = num_gpus()
        if n == 0:
            raise RuntimeError(
                "context gpu(%d) needs CUDA, but torch.cuda.is_available() is "
                "False; pass ctx=cpu() to run on the CPU" % self.device_id)
        if self.device_id >= n:
            raise RuntimeError("context gpu(%d) does not exist: %d CUDA "
                               "device(s) visible" % (self.device_id, n))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        self._old_ctx = getattr(Context._default_ctx, "value", None)
        Context._default_ctx.value = self
        return self

    def __exit__(self, *args):
        Context._default_ctx.value = self._old_ctx

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (self.device_type, self.device_id)


def cpu(device_id=0):
    return Context("cpu", device_id)


def gpu(device_id=0):
    """The first-class accelerator context: ``torch.device('cuda', i)``."""
    return Context("gpu", device_id)


def tpu(device_id=0):
    """Migration alias of ``gpu(device_id)``."""
    return gpu(device_id)


def num_gpus():
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def current_context():
    """The innermost ``with ctx:`` scope, else ``gpu(0)``. Raises when no
    scope is open and CUDA is absent (no silent CPU fallback)."""
    ctx = getattr(Context._default_ctx, "value", None)
    if ctx is not None:
        return ctx
    ctx = gpu(0)
    ctx.torch_device  # noqa: B018 — raises without CUDA
    return ctx


def as_device(ctx):
    """``torch.device`` for a Context, a ``torch.device``, a device string or
    None (the current context)."""
    if ctx is None:
        ctx = current_context()
    if isinstance(ctx, Context):
        return ctx.torch_device
    return torch.device(ctx)
