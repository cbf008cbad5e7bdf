"""Training and inference steps (counterpart of
``incubator_mxnet_tpu/jit.py``).

PyTorch runs eagerly, so there is no program to trace, compile or cache.
``EvalStep`` moves its inputs to the net's device and runs the forward
without recording (under ``torch.inference_mode()`` for the serving path).
``TrainStep`` runs the forward in training mode, the loss, its backward and
the optimizer's update of every parameter in place (the counterpart of the
JAX step's donated buffers), single-device; ``mesh``, ``zero``, ``remat``
and ``grad_postprocess`` wait for the slices named in their errors. Inputs
may be NDArrays, tensors or numpy arrays; both steps return NDArrays, as
the JAX package's do.
"""
from __future__ import annotations

import numpy as onp
import torch

from . import autograd
from .ndarray import NDArray

__all__ = ["TrainStep", "EvalStep"]


def net_device(net):
    """The device of the net's (first) parameter."""
    for p in net.parameters():
        return p.device
    raise RuntimeError("%s has no initialized parameters; call "
                       ".initialize() first" % type(net).__name__)


def _to_device(inputs, device):
    inputs = [x._data if isinstance(x, NDArray) else x for x in inputs]
    return [x.to(device) if isinstance(x, torch.Tensor)
            else torch.as_tensor(onp.asarray(x)).to(device) for x in inputs]


class TrainStep:
    """``step(*inputs)`` = one training step: ``inputs`` are the net's
    inputs (the first ``n_net_inputs``) followed by the loss's extra
    arguments (labels). Returns the per-sample loss as an NDArray.

    The step is: a forward in training mode, ``loss_fn(out, *extra)``, the
    gradients of the loss (seeded with ones, as ``loss.backward()``) with
    respect to the trainer's parameters, then for each parameter (under
    ``torch.no_grad()``) ``grad * rescale_grad / batch_size``, the clip,
    the fp32 update of the master (or of the fp32 weight) and the cast into
    the weight, in place (``Trainer.step``'s loop). The gradients are the
    step's own: like the JAX ``TrainStep``, it leaves each parameter's
    ``grad()`` as it was. Adam's bias-correction step ``t`` is this step's
    own count."""

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
        grads = self._backward(loss)
        self._update(batch_size, grads)
        return NDArray(loss.detach())

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
            loss = self.loss_fn(out, *args[n_net_inputs:])
        return loss._data if isinstance(loss, NDArray) else loss

    def _backward(self, loss):
        """The loss's gradients (seeded with ones: those of its sum, which
        rescale_grad / batch_size makes the batch mean's), one per trainer
        parameter, None where it does not reach."""
        params = self.trainer._params
        live = [i for i, p in enumerate(params) if p.grad_req != "null"]
        got = torch.autograd.grad(loss, [params[i]._tensor() for i in live],
                                  torch.ones_like(loss), allow_unused=True)
        grads = [None] * len(params)
        for i, g in zip(live, got):
            grads[i] = g
        return grads

    def _update(self, batch_size, grads):
        self._step_count += 1
        self.trainer._update(batch_size, t=self._step_count, grads=grads)


class EvalStep:
    """``step(*inputs)`` = ``net(*inputs)`` in inference mode on the net's
    device, as NDArrays. Inputs may be NDArrays, tensors or numpy arrays."""

    def __init__(self, net):
        self.net = net

    def __call__(self, *inputs):
        from .ndarray.ndarray import _wrap
        args = _to_device(inputs, net_device(self.net))
        with torch.no_grad():
            return _wrap(self.net(*args), args)

    def _run(self, *inputs):
        """The forward's tensors, unwrapped, under ``torch.inference_mode()``
        (the serving path's call; its tensors cannot be written outside
        inference mode, so the NDArrays of ``__call__`` are not these)."""
        with torch.inference_mode():
            return self.net(*_to_device(inputs, net_device(self.net)))
