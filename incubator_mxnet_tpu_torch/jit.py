"""Training and inference steps (counterpart of
``incubator_mxnet_tpu/jit.py``).

PyTorch runs eagerly, so there is no program to trace, compile or cache.
``EvalStep`` moves its inputs to the net's device and runs the forward under
``torch.inference_mode()``. ``TrainStep`` runs the forward in training mode,
the loss, ``loss.sum().backward()`` and the optimizer's update of every
parameter in place (the counterpart of the JAX step's donated buffers),
single-device; ``mesh``, ``zero``, ``remat`` and ``grad_postprocess`` wait
for the slices named in their errors.
"""
from __future__ import annotations

import numpy as onp
import torch

from . import autograd

__all__ = ["TrainStep", "EvalStep"]


def net_device(net):
    """The device of the net's (first) parameter."""
    for p in net.parameters():
        return p.device
    raise RuntimeError("%s has no initialized parameters; call "
                       ".initialize() first" % type(net).__name__)


def _to_device(inputs, device):
    return [x.to(device) if isinstance(x, torch.Tensor)
            else torch.as_tensor(onp.asarray(x)).to(device) for x in inputs]


class TrainStep:
    """``step(*inputs)`` = one training step: ``inputs`` are the net's
    inputs (the first ``n_net_inputs``) followed by the loss's extra
    arguments (labels). Returns the per-sample loss, detached.

    The step is: a forward in training mode, ``loss_fn(out, *extra)``, the
    backward of the loss's sum, then for each parameter of the trainer
    (under ``torch.no_grad()``) ``grad * rescale_grad / batch_size``, the
    clip, the fp32 update of the master (or of the fp32 weight) and the
    cast into the weight, in place (``Trainer.step``'s loop); the trainer's
    gradients are then released. Adam's bias-correction step ``t`` is this
    step's own count."""

    def __init__(self, net, loss_fn, trainer, batch_axis=0,
                 grad_postprocess=None, mesh=None, remat=None, zero=False):
        if mesh is not None or zero:
            raise NotImplementedError(
                "TrainStep mesh/zero (data-parallel and ZeRO-1 sharding) "
                "come with the multi-GPU slice of the port")
        if remat:
            raise NotImplementedError(
                "TrainStep remat (activation recomputation) comes with the "
                "fused-step slice of the port")
        if grad_postprocess is not None:
            raise NotImplementedError(
                "TrainStep grad_postprocess comes with the multi-GPU slice "
                "of the port")
        self.net = net
        self.loss_fn = loss_fn
        self.trainer = trainer
        self.batch_axis = batch_axis
        self._step_count = 0

    def __call__(self, *inputs, batch_size=None, n_net_inputs=1):
        args = self._prepare(inputs, n_net_inputs)
        if batch_size is None:
            batch_size = args[0].shape[self.batch_axis]
        loss = self._forward(args, n_net_inputs)
        self._backward(loss)
        self._update(batch_size)
        return loss.detach()

    def _prepare(self, inputs, n_net_inputs):
        """Inputs on the net's device; deferred parameters initialized by
        one forward; the trainer's states created."""
        params = list(self.net.collect_params().values())
        if any(p._data is None for p in params):
            device = next((p._data.device for p in params
                           if p._data is not None), None) or \
                next(p._deferred_init[2] for p in params
                     if p._deferred_init is not None)
            args = _to_device(inputs, device)
            with autograd.pause(train_mode=True):
                self.net(*args[:n_net_inputs])
        else:
            args = _to_device(inputs, net_device(self.net))
        if not self.trainer._states_initialized:
            self.trainer._init_states()
        return args

    def _forward(self, args, n_net_inputs):
        with autograd.record(train_mode=True):
            out = self.net(*args[:n_net_inputs])
            return self.loss_fn(out, *args[n_net_inputs:])

    def _backward(self, loss):
        # seed-of-ones: the gradients of the sum; rescale_grad / batch_size
        # then makes them the batch mean's
        loss.sum().backward()

    def _update(self, batch_size):
        self._step_count += 1
        self.trainer._update(batch_size, t=self._step_count)
        for param in self.trainer._params:
            param.zero_grad()


class EvalStep:
    """``step(*inputs)`` = ``net(*inputs)`` in inference mode on the net's
    device. Inputs may be tensors or numpy arrays."""

    def __init__(self, net):
        self.net = net

    def __call__(self, *inputs):
        device = net_device(self.net)
        with torch.inference_mode():
            return self.net(*_to_device(inputs, device))
