"""Record/pause scopes and the training flag over torch's autograd
(counterpart of ``incubator_mxnet_tpu/autograd.py``).

The JAX package keeps its own tape; the port hands gradients to
``torch.autograd``. What it keeps is MXNet's scope contract:

- ``record(train_mode=True)`` turns gradient recording on (torch's grad
  mode) and sets the training flag; ``pause(train_mode=False)`` turns
  recording off; ``train_mode()`` / ``predict_mode()`` set only the flag.
- The training flag is thread-local and decides whether dropout is active
  (``ndarray.Dropout``), exactly where the JAX package's flag does.
- ``backward(heads, head_grads)`` seeds each head with ones (or the given
  gradients), as ``loss.backward()`` on a non-scalar loss does in MXNet.

Gradients land in each parameter's tensor (``Parameter.grad()``) and add
up across backward calls, as torch's do, until ``Trainer.step`` consumes
them or ``zero_grad`` clears them.
"""
from __future__ import annotations

import threading

import torch

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "backward"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_STATE = _State()


def is_recording():
    return _STATE.recording


def is_training():
    return _STATE.training


def set_recording(is_record):
    """Set the recording flag (and torch's grad mode); returns the old flag."""
    prev = _STATE.recording
    _STATE.recording = bool(is_record)
    torch.set_grad_enabled(_STATE.recording)
    return prev


def set_training(train_mode_):
    prev = _STATE.training
    _STATE.training = bool(train_mode_)
    return prev


class _Scope:
    """Set recording and/or training on entry, restore both on exit."""

    def __init__(self, is_record, train_mode_):
        self._record = is_record
        self._train = train_mode_
        self._prev = None

    def __enter__(self):
        self._prev = (_STATE.recording, _STATE.training,
                      torch.is_grad_enabled())
        if self._record is not None:
            _STATE.recording = self._record
            torch.set_grad_enabled(self._record)
        if self._train is not None:
            _STATE.training = self._train
        return self

    def __exit__(self, *exc):
        _STATE.recording, _STATE.training, grad = self._prev
        torch.set_grad_enabled(grad)


def record(train_mode=True):
    """Scope in which operations are recorded for ``backward``."""
    return _Scope(True, train_mode)


def pause(train_mode=False):
    """Scope in which nothing is recorded."""
    return _Scope(False, train_mode)


def train_mode():
    return _Scope(None, True)


def predict_mode():
    return _Scope(None, False)


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of ``heads`` into the parameters they depend on. Each head
    is seeded with ones unless ``head_grads`` gives its gradient."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    grads = [torch.ones_like(h) if g is None else g
             for h, g in zip(heads, head_grads)]
    with _Scope(None, train_mode):
        torch.autograd.backward(heads, grads, retain_graph=retain_graph)
