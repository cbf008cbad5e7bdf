"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py``).

The same contract as the JAX package: ``rescale_grad``, ``clip_gradient``,
``wd`` with per-parameter ``lr_mult``/``wd_mult``, per-index update counts,
``create_state_multi_precision`` (an fp32 master copy beside a bf16/fp16
weight) and ``update`` / ``update_multi_precision``. Weight decay applies to
every parameter, biases and LayerNorm scales included, as MXNet's does.

Where the JAX package's ``update_rule`` is a pure function returning a new
weight and state, the port's updates its fp32 weight (the master, or the
fp32 parameter itself) and its state tensors in place, under
``torch.no_grad()``: the counterpart of the JAX step's donated buffers.

Ported so far: SGD (with momentum), Adam and AdamW. The other optimizers of
the JAX package's registry are not ported yet.
"""
from __future__ import annotations

import math

import torch

from ..base import registry

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "create", "register"]

_REG = registry("optimizer")
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def register(klass):
    return _REG.register(klass)


def create(name, **kwargs):
    return _REG.create(name, **kwargs)


class Optimizer:
    """Base optimizer."""

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 **kwargs):
        if lr_scheduler is not None:
            raise NotImplementedError("lr_scheduler is not ported yet")
        if kwargs:
            raise TypeError("unexpected optimizer arguments %s"
                            % sorted(kwargs))
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = dict(param_idx2name or {})
        self.param_dict = param_dict or {}

    @staticmethod
    def create_optimizer(name, **kwargs):
        return create(name, **kwargs)

    # -- state ---------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _uses_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    def create_state_multi_precision(self, index, weight):
        """(fp32 master, inner state) for a bf16/fp16 weight under
        ``multi_precision``, else the plain state."""
        if self._uses_master(weight):
            master = weight.detach().float().clone()
            return (master, self.create_state(index, master))
        return self.create_state(index, weight)

    # -- schedules -----------------------------------------------------
    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = dict(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = dict(args_wd_mult)

    def set_learning_rate(self, lr):
        self.lr = lr

    @property
    def learning_rate(self):
        return self.lr

    # -- the update rule (override in subclasses) ----------------------
    def update_rule(self, weight, grad, state, lr, wd, t):
        """Update the fp32 ``weight`` and ``state`` in place from the fp32
        ``grad`` at step ``t``."""
        raise NotImplementedError

    # -- eager entry points (Trainer calls these) ----------------------
    def update(self, index, weight, grad, state, t=None):
        """Update ``weight`` in fp32 and cast back; returns the state."""
        return self._update(index, weight, grad, state, t, False)

    def update_multi_precision(self, index, weight, grad, state, t=None):
        """fp32 master-weight update for bf16/fp16 weights under
        ``multi_precision``; ``update`` otherwise."""
        return self._update(index, weight, grad, state, t,
                            self._uses_master(weight))

    @torch.no_grad()
    def _update(self, index, weight, grad, state, t, use_master):
        """``grad * rescale_grad``, the clip, the fp32 update of the master
        (or of the weight in fp32) and the cast into ``weight``, all in
        place. ``t``, Adam's bias-correction step, defaults to this index's
        update count. ``grad`` None counts as zeros. Returns the state."""
        self._update_count(index)
        if t is None:
            t = self._index_update_count[index]
        lr, wd = self._get_lr(index), self._get_wd(index)
        g = torch.zeros(weight.shape, dtype=torch.float32,
                        device=weight.device) if grad is None \
            else grad.float() * self.rescale_grad
        if self.clip_gradient is not None:
            g.clamp_(-self.clip_gradient, self.clip_gradient)
        if use_master:
            master, inner = state
            self.update_rule(master, g, inner, lr, wd, t)
            weight.copy_(master)
        else:
            w32 = weight if weight.dtype == torch.float32 else weight.float()
            self.update_rule(w32, g, state, lr, wd, t)
            if w32 is not weight:
                weight.copy_(w32)
        return state


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w)``,
    ``w += mom`` (``w -= lr * (g + wd * w)`` without momentum)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return torch.zeros(weight.shape, dtype=torch.float32,
                           device=weight.device)

    def update_rule(self, w, g, state, lr, wd, t):
        g = g + wd * w
        if state is None:
            w.sub_(lr * g)
            return
        state.mul_(self.momentum).sub_(lr * g)
        w.add_(state)


@register
class Adam(Optimizer):
    """Adam with the bias correction folded into the step size at step
    ``t``: ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (torch.zeros(weight.shape, dtype=torch.float32,
                            device=weight.device),
                torch.zeros(weight.shape, dtype=torch.float32,
                            device=weight.device))

    def _moments(self, g, state, t):
        """Advance m and v in place; returns lr_t / lr."""
        m, v = state
        m.mul_(self.beta1).add_((1 - self.beta1) * g)
        v.mul_(self.beta2).add_((1 - self.beta2) * g * g)
        return math.sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)

    def update_rule(self, w, g, state, lr, wd, t):
        lr_t = lr * self._moments(g + wd * w, state, t)
        m, v = state
        w.sub_(lr_t * m / (v.sqrt() + self.epsilon))


@register
class AdamW(Adam):
    """Adam with decoupled weight decay:
    ``w -= lr_t * (m / (sqrt(v) + eps) + wd * w)``."""

    def update_rule(self, w, g, state, lr, wd, t):
        lr_t = lr * self._moments(g, state, t)
        m, v = state
        w.sub_(lr_t * (m / (v.sqrt() + self.epsilon) + wd * w))
