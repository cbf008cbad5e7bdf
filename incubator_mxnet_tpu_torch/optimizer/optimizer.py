"""Optimizers (counterpart of ``incubator_mxnet_tpu/optimizer/optimizer.py``).

The same contract as the JAX package: ``rescale_grad``, ``clip_gradient``,
``wd`` with per-parameter ``lr_mult``/``wd_mult``, per-index update counts,
``create_state_multi_precision`` (an fp32 master copy beside a bf16/fp16
weight) and ``update`` / ``update_multi_precision``. Weight decay applies to
every parameter, biases and LayerNorm scales included, as MXNet's does.

Every update goes through ``update_all``: one update of a list of
parameters with the JAX ``TrainStep``'s arithmetic (``jit.py:236-257``),
taking the learning rates, weight decays, bias-correction steps and the
gradient rescale as fp32 device tensors, so that a captured CUDA graph can
replay it with new values. ``Trainer.step``, ``jit.TrainStep`` and the
per-index ``update`` all call it. Where the JAX package's ``update_rule`` is
a pure function returning a new weight and state, the port's
``multi_update_rule`` updates the fp32 weights (the masters, or the fp32
parameters themselves) and the state tensors in place, under
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
    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        """Update the fp32 ``weights`` and their ``states`` in place from
        the fp32 ``grads`` (which it may overwrite). ``lrs`` and ``wds``
        are fp32 device vectors, one entry per weight; ``t``, the
        bias-correction step, is a device scalar or one entry per
        weight."""
        raise NotImplementedError

    # -- the update ------------------------------------------------------
    def step_scalars(self, indices, t=None):
        """Advance the update count of each index and return the host fp32
        vector ``[lrs, wds, ts, rescale]`` that ``update_all`` takes (after
        ``split_scalars``): each index's learning rate and weight decay,
        its bias-correction step (``t``, or by default its update count)
        and ``rescale_grad``."""
        lrs, wds, ts = [], [], []
        for i in indices:
            self._update_count(i)
            lrs.append(self._get_lr(i))
            wds.append(self._get_wd(i))
            ts.append(self._index_update_count[i] if t is None else t)
        return torch.tensor(lrs + wds + ts + [self.rescale_grad],
                            dtype=torch.float32)

    @staticmethod
    def split_scalars(scalars):
        """(lrs, wds, t, rescale): views of a ``step_scalars`` vector."""
        n = (scalars.shape[0] - 1) // 3
        return (scalars[:n], scalars[n:2 * n], scalars[2 * n:3 * n],
                scalars[3 * n])

    @torch.no_grad()
    def update_all(self, weights, grads, states, lrs, wds, t, rescale,
                   use_master=None):
        """One update of every weight, in place: ``grad * rescale`` in fp32,
        the clip, ``multi_update_rule`` on the fp32 masters (bf16/fp16
        weights under ``multi_precision``, whose state is ``(master,
        inner)``) or on the weights in fp32, then the cast into each
        weight. A ``None`` gradient counts as zeros. ``lrs``/``wds`` are
        fp32 device vectors (one entry per weight), ``t`` a device scalar
        or vector (or a host number: see ``Adam._moments``), ``rescale`` a
        device scalar: nothing here reads a device value on the host, so a
        CUDA graph can capture it. ``use_master`` (default:
        ``multi_precision`` and a low-precision weight) says per weight
        whether its state holds a master."""
        if not weights:
            return
        if use_master is None:
            use_master = [self._uses_master(w) for w in weights]
        g32 = [torch.zeros(w.shape, dtype=torch.float32, device=w.device)
               if g is None else g.float() for w, g in zip(weights, grads)]
        g32 = torch._foreach_mul(g32, rescale)
        if self.clip_gradient is not None:
            torch._foreach_clamp_min_(g32, -self.clip_gradient)
            torch._foreach_clamp_max_(g32, self.clip_gradient)
        w32, inner = [], []
        for w, s, master in zip(weights, states, use_master):
            if master:
                w32.append(s[0])
                inner.append(s[1])
            else:
                w32.append(w if w.dtype == torch.float32 else w.float())
                inner.append(s)
        self.multi_update_rule(w32, g32, inner, lrs, wds, t)
        back = [(w, w2) for w, w2 in zip(weights, w32) if w2 is not w]
        if back:
            torch._foreach_copy_([w for w, _ in back], [w2 for _, w2 in back])

    # -- eager entry points ------------------------------------------
    def update(self, index, weight, grad, state, t=None):
        """Update ``weight`` in fp32 and cast back; returns the state."""
        return self._update(index, weight, grad, state, t, False)

    def update_multi_precision(self, index, weight, grad, state, t=None):
        """fp32 master-weight update for bf16/fp16 weights under
        ``multi_precision``; ``update`` otherwise."""
        return self._update(index, weight, grad, state, t,
                            self._uses_master(weight))

    def _update(self, index, weight, grad, state, t, use_master):
        """``update_all`` of one weight; ``t``, Adam's bias-correction
        step, defaults to this index's update count and stays on the host,
        as in the JAX package's eager ``update``. Returns the state."""
        scalars = self.step_scalars([index], t).to(weight.device)
        lrs, wds, _, rescale = self.split_scalars(scalars)
        self.update_all([weight], [grad], [state], lrs, wds,
                        self._index_update_count[index] if t is None else t,
                        rescale, use_master=[use_master])
        return state


def _wd_terms(weights, wds):
    """``wd_i * w_i`` for each weight (per-weight device scalars)."""
    return torch._foreach_mul(weights, list(wds.unbind(0)))


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

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        steps = torch._foreach_mul(grads, list(lrs.unbind(0)))
        if self.momentum == 0.0:
            torch._foreach_sub_(weights, steps)
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_sub_(states, steps)
        torch._foreach_add_(weights, states)


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

    def _moments(self, grads, states, lrs, t):
        """Advance every m and v in place; returns (the per-weight
        ``m / (sqrt(v) + eps)``, the step sizes ``lr_t``), with
        ``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)``: in fp32 on the
        device for a tensor ``t``, as the JAX step computes it from its
        int32 ``t``; from the powers in double for a host ``t``, as the
        JAX package's eager ``update`` computes them."""
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, grads, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - self.beta2)
        denom = torch._foreach_sqrt(vs)
        torch._foreach_add_(denom, self.epsilon)
        sqrt = torch.sqrt if isinstance(t, torch.Tensor) else math.sqrt
        lr_t = lrs * sqrt(1 - self.beta2 ** t) / (1 - self.beta1 ** t)
        return torch._foreach_div(ms, denom), lr_t

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        steps, lr_t = self._moments(grads, states, lrs, t)
        torch._foreach_mul_(steps, list(lr_t.unbind(0)))
        torch._foreach_sub_(weights, steps)


@register
class AdamW(Adam):
    """Adam with decoupled weight decay:
    ``w -= lr_t * (m / (sqrt(v) + eps) + wd * w)``."""

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        steps, lr_t = self._moments(grads, states, lrs, t)
        torch._foreach_add_(steps, _wd_terms(weights, wds))
        torch._foreach_mul_(steps, list(lr_t.unbind(0)))
        torch._foreach_sub_(weights, steps)
