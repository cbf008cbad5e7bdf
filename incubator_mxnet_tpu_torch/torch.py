"""The PyTorch bridge (counterpart of ``incubator_mxnet_tpu/torch.py``;
MXNet's ``python/mxnet/torch.py``).

In the port an NDArray already holds a ``torch.Tensor``, so the bridge
copies rather than converts:

- ``to_torch`` returns a tensor that does NOT alias the array, on the
  array's device (the reference returns a host copy: on the card the port
  keeps the device, a departure logged in ROADMAP §3); ``from_torch``
  copies a tensor onto ``ctx`` (the current context when None).
- ``torch_function`` runs a differentiable torch function under the tape:
  its backward is torch's, handed back as the node's gradient, and a
  full ``torch.autograd.backward`` also accumulates ``.grad`` into any
  torch parameters inside the function.
- ``TorchBlock`` wraps a ``torch.nn.Module`` (its parameters trained by a
  torch optimizer from those ``.grad``s) and runs it where its inputs are.

Not imported by the package's ``__init__``: ``import
incubator_mxnet_tpu_torch.torch`` is opt-in, as in the reference. Inside
the package ``import torch`` stays PyTorch (absolute imports).
"""
from __future__ import annotations

import torch as _t

from .context import as_device
from .ndarray import NDArray
from . import autograd

__all__ = ["to_torch", "from_torch", "torch_function", "TorchBlock"]


def to_torch(arr):
    """NDArray → a ``torch.Tensor`` of its own (a copy, detached), on the
    array's device."""
    data = arr._data if isinstance(arr, NDArray) else arr
    return data.detach().clone()


def from_torch(tensor, ctx=None):
    """``torch.Tensor`` → an NDArray holding a copy on ``ctx``."""
    return NDArray(tensor.detach().to(as_device(ctx), copy=True))


def torch_function(fn, *inputs):
    """Run ``fn(*torch_tensors) -> torch_tensor`` under the tape; its
    gradient is torch's."""

    class _Bridge(autograd.Function):
        def forward(self, *arrs):
            self._tins = [
                (a._data if isinstance(a, NDArray) else _t.as_tensor(a))
                .detach().clone().requires_grad_(True) for a in arrs]
            with _t.enable_grad():
                out = fn(*self._tins)
            self._tout = out
            return NDArray(out.detach().clone())

        def backward(self, dout):
            # a full backward (not autograd.grad of the inputs): gradients
            # also accumulate into torch parameters inside fn, so a
            # TorchBlock's module trains with a torch optimizer
            _t.autograd.backward(self._tout, grad_tensors=dout._data)
            return tuple(NDArray(_t.zeros_like(i)) if i.grad is None
                         else NDArray(i.grad) for i in self._tins)

    return _Bridge()(*inputs)


class TorchBlock(object):
    """A ``torch.nn.Module`` in imperative flows (MXNet's TorchModule
    wrappers). It runs on its inputs' device (move the module there);
    under ``autograd.record()`` input gradients flow back through
    ``torch_function`` and the module's parameters accumulate ``.grad``
    for a torch optimizer."""

    def __init__(self, module):
        self.module = module

    def __call__(self, *inputs):
        def run(*tins):
            return self.module(*tins)
        return torch_function(run, *inputs)

    def parameters(self):
        return self.module.parameters()
