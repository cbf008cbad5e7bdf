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

All 17 optimizers of the JAX package's registry are here. Per-tensor norms
(LAMB, LARS) come from ``torch._foreach_norm`` and their trust ratios from a
device ``torch.where``; Nadam's momentum schedule, host state in the JAX
package, is a float64 device scalar advanced by a running product over the
parameters in index order; SGLD draws its noise from ``nd.random``'s
generator of the weights' device, which a captured step registers, so each
replay draws afresh. ``lr_scheduler`` is evaluated on the host
(``step_scalars``) and reaches the device vector of learning rates.

The eager entry points take what MXNet's code passes: ``create_state``,
``create_state_multi_precision``, ``update`` and ``update_multi_precision``
take NDArrays as well as tensors (``p.data()``, ``p.grad()`` and the
states of MXNet's custom training loop). An NDArray weight gets a state of
NDArrays over the state's tensors, and ``update`` writes the weight and the
state in place, so the caller's arrays hold the new values. A row-sparse
gradient (``nd.sparse.RowSparseNDArray``) updates only the rows it carries,
weight and momentum, under SGD's ``lazy_update``, and is made dense
everywhere else, as the JAX package does.

``Updater`` keeps one state per index and writes and reads the JAX
package's state pickles (``get_states``/``set_states``: numpy arrays in
nested tuples), which ``gluon.Trainer.save_states``/``load_states`` use.
"""
from __future__ import annotations

import functools
import math
import pickle

import numpy as onp
import torch

from ..base import registry
from ..ndarray import NDArray
from ..ndarray import random as _random
from ..ndarray.sparse import RowSparseNDArray

__all__ = ["Optimizer", "SGD", "Adam", "AdamW", "NAG", "RMSProp", "AdaGrad",
           "AdaDelta", "Adamax", "Nadam", "Ftrl", "FTML", "LAMB", "LARS",
           "Signum", "SGLD", "DCASGD", "Test", "create", "register",
           "Updater", "get_updater"]

_REG = registry("optimizer")
_LOW_PRECISION = (torch.bfloat16, torch.float16)


def register(klass):
    return _REG.register(klass)


def create(name, **kwargs):
    return _REG.create(name, **kwargs)


def _takes_ndarrays(create):
    """``create(self, index, weight)`` that also takes an NDArray weight
    and then gives the state as NDArrays over its tensors."""
    @functools.wraps(create)
    def wrapped(self, index, weight):
        if not isinstance(weight, NDArray):
            return create(self, index, weight)
        return _as_ndarrays(create(self, index, weight._data))
    wrapped.takes_ndarrays = True
    return wrapped


class Optimizer:
    """Base optimizer."""

    def __init_subclass__(cls, **kwargs):
        # every subclass's create_state takes an NDArray weight too
        super().__init_subclass__(**kwargs)
        for name in ("create_state", "create_state_multi_precision"):
            fn = cls.__dict__.get(name)
            if fn is not None and not getattr(fn, "takes_ndarrays", False):
                setattr(cls, name, _takes_ndarrays(fn))

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 begin_num_update=0, multi_precision=False, param_dict=None,
                 **kwargs):
        if kwargs:
            raise TypeError("unexpected optimizer arguments %s"
                            % sorted(kwargs))
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
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
    @_takes_ndarrays
    def create_state(self, index, weight):
        return None

    def _uses_master(self, weight):
        return self.multi_precision and weight.dtype in _LOW_PRECISION

    @_takes_ndarrays
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
        lr = self.lr_scheduler(self.num_update) \
            if self.lr_scheduler is not None else self.lr
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
        if self.lr_scheduler is not None:
            raise UserWarning("lr_scheduler is set; cannot set learning "
                              "rate directly")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    # -- the update rule (override in subclasses) ----------------------
    def update_rule(self, weight, grad, state, lr, wd, t):
        """The JAX package's per-weight hook: ``(fp32 weight, fp32 grad,
        state, lr, wd, t) -> (new_weight, new_state)``, pure. A user's
        optimizer may define it alone (``multi_update_rule`` then runs it
        per weight; ``lr``, ``wd`` and ``t`` arrive as 0-d fp32 device
        tensors, or ``t`` a host number, so a rule of torch ops captures
        in a CUDA graph). For the built-in optimizers it is their
        ``multi_update_rule`` on copies of one weight and its state, the
        gradient already rescaled and clipped, as the JAX package's
        ``update_rule`` takes it."""
        if type(self).multi_update_rule is Optimizer.multi_update_rule:
            raise NotImplementedError(
                "%s defines neither update_rule nor multi_update_rule"
                % type(self).__name__)
        w = weight.detach().float().clone()
        device = w.device

        def vec(x):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=device).reshape(1)
        new_state = _map_state(state, torch.clone)
        self._rescale = torch.ones((), dtype=torch.float32, device=device)
        self.multi_update_rule([w], [grad.detach().float().clone()],
                               [new_state], vec(lr), vec(wd), t)
        return w, new_state

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        """Update the fp32 ``weights`` and their ``states`` in place from
        the fp32 ``grads`` (which it may overwrite). ``lrs`` and ``wds``
        are fp32 device vectors, one entry per weight; ``t``, the
        bias-correction step, is a device scalar or one entry per
        weight. The base runs a subclass's ``update_rule`` on each weight
        and writes its results into the weight and the state tensors."""
        if type(self).update_rule is Optimizer.update_rule:
            raise NotImplementedError(
                "%s defines neither multi_update_rule nor update_rule"
                % type(self).__name__)
        per_weight = isinstance(t, torch.Tensor) and t.dim() == 1
        for i, (w, g, s) in enumerate(zip(weights, grads, states)):
            new_w, new_s = self.update_rule(w, g, s, lrs[i], wds[i],
                                            t[i] if per_weight else t)
            w.copy_(new_w)
            _write_state(s, new_s, type(self).__name__)

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
        self._rescale = rescale
        self.multi_update_rule(w32, g32, inner, lrs, wds, t)
        back = [(w, w2) for w, w2 in zip(weights, w32) if w2 is not w]
        if back:
            torch._foreach_copy_([w for w, _ in back], [w2 for _, w2 in back])

    # -- eager entry points ------------------------------------------
    def update(self, index, weight, grad, state, t=None):
        """Update ``weight`` in fp32 and cast back; returns the state.
        ``weight``, ``grad`` and the state's arrays are tensors or
        NDArrays; the weight and the state are written in place."""
        return self._update(index, weight, grad, state, t, False)

    def update_multi_precision(self, index, weight, grad, state, t=None):
        """fp32 master-weight update for bf16/fp16 weights under
        ``multi_precision``; ``update`` otherwise."""
        return self._update(index, weight, grad, state, t,
                            self._uses_master(_tensor_of(weight)))

    def _update(self, index, weight, grad, state, t, use_master):
        """``update_all`` of one weight; ``t``, Adam's bias-correction
        step, defaults to this index's update count and stays on the host,
        as in the JAX package's eager ``update``. Returns the state (the
        caller's object, updated in place)."""
        weight, tensors = _tensor_of(weight), _state_tensors(state)
        if isinstance(grad, RowSparseNDArray):
            if not use_master and self._sparse_lazy_supported():
                self._update_rows(index, weight, grad, tensors, t)
                return state
            grad = grad.tostype("default")
        scalars = self.step_scalars([index], t).to(weight.device)
        lrs, wds, _, rescale = self.split_scalars(scalars)
        self.update_all([weight], [_tensor_of(grad)], [tensors], lrs, wds,
                        self._index_update_count[index] if t is None else t,
                        rescale, use_master=[use_master])
        return state

    def _sparse_lazy_supported(self):
        """Whether a row-sparse gradient updates only its rows."""
        return False

    @torch.no_grad()
    def _update_rows(self, index, weight, grad, state, t):
        """The lazy update: the rule on the rows ``grad`` carries, of the
        weight and of the state, written back into those rows alone."""
        rows = grad.indices._data.to(weight.device, torch.long)
        w_rows = weight[rows]
        s_rows = _map_state(state, lambda s: s[rows])
        self._update(index, w_rows, grad.data._data, s_rows, t, False)
        weight[rows] = w_rows
        _map_state(state, lambda s, new: s.index_copy_(0, rows, new),
                   s_rows)


def _write_state(state, new, name):
    """Copy ``update_rule``'s new state into the held one, tensor by tensor
    (a state is None, a tensor, or a tuple or list of them)."""
    if isinstance(state, torch.Tensor):
        state.copy_(new)
    elif isinstance(state, (tuple, list)):
        if not isinstance(new, (tuple, list)) or len(new) != len(state):
            raise ValueError("%s.update_rule changed its state's structure"
                             % name)
        for old, n in zip(state, new):
            _write_state(old, n, name)
    elif state is not None or new is not None:
        raise ValueError("%s.update_rule returned a state of another kind "
                         "than create_state's" % name)


def _wd_terms(weights, wds):
    """``wd_i * w_i`` for each weight (per-weight device scalars)."""
    return torch._foreach_mul(weights, list(wds.unbind(0)))


@register
class SGD(Optimizer):
    """SGD with momentum: ``mom = momentum * mom - lr * (g + wd * w)``,
    ``w += mom`` (``w -= lr * (g + wd * w)`` without momentum).
    ``lazy_update`` (MXNet's, on by default): a row-sparse gradient given
    to ``update`` moves only the rows it carries, weight and momentum,
    weight decay included; ``Trainer``'s gradients are dense, so every row
    updates there, as in the JAX package."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def _sparse_lazy_supported(self):
        return self.lazy_update

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


def _each(x, n):
    """``x`` as ``n`` per-weight scalars: the entries of a device vector,
    or a device scalar or host number ``n`` times."""
    if isinstance(x, torch.Tensor) and x.dim() == 1:
        return list(x.unbind(0))
    return [x] * n


def _zeros(weight):
    return torch.zeros(weight.shape, dtype=torch.float32,
                       device=weight.device)


def _norms(tensors):
    """The L2 norm of each tensor, as one fp32 device vector."""
    return torch.stack(torch._foreach_norm(tensors))


@register
class Test(Optimizer):
    """``w += g * rescale_grad`` (on a gradient already rescaled)."""

    def create_state(self, index, weight):
        return torch.zeros(weight.shape, dtype=weight.dtype,
                           device=weight.device)

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(weights, torch._foreach_mul(grads,
                                                        self._rescale))


@register
class NAG(SGD):
    """Nesterov momentum: ``mom = momentum * mom + g'``,
    ``w -= lr * (g' + momentum * mom)`` with ``g' = g + wd * w``. A
    row-sparse gradient is made dense (no lazy rows), as in the JAX
    package."""

    def _sparse_lazy_supported(self):
        return False

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        if self.momentum == 0.0:
            torch._foreach_sub_(weights, torch._foreach_mul(
                grads, list(lrs.unbind(0))))
            return
        torch._foreach_mul_(states, self.momentum)
        torch._foreach_add_(states, grads)
        step = torch._foreach_add(grads, states, alpha=self.momentum)
        torch._foreach_mul_(step, list(lrs.unbind(0)))
        torch._foreach_sub_(weights, step)


@register
class Signum(Optimizer):
    """signSGD with momentum: ``w = w * (1 - lr * wd_lh) + lr *
    sign(mom)``, ``mom = momentum * mom - (1 - momentum) * (g + wd * w)``
    (``sign(g + wd * w)`` without momentum)."""

    def __init__(self, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros(weight)

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        lr = list(lrs.unbind(0))
        if self.momentum == 0.0:
            signs = torch._foreach_sign(grads)
            torch._foreach_mul_(signs, lr)
            signs = torch._foreach_neg(signs)
        else:
            torch._foreach_mul_(states, self.momentum)
            torch._foreach_add_(states, grads, alpha=-(1 - self.momentum))
            signs = torch._foreach_sign(states)
            torch._foreach_mul_(signs, lr)
        torch._foreach_mul_(weights, list((1 - lrs * self.wd_lh).unbind(0)))
        torch._foreach_add_(weights, signs)


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics: ``w -= lr / 2 * (g + wd * w)``
    plus normal noise of variance ``lr``, drawn from ``nd.random``'s
    generator of the weights' device."""

    def _noise(self, weights):
        """One standard normal draw of each weight's shape."""
        return [torch.randn(w.shape, dtype=torch.float32, device=w.device,
                            generator=_random._generator(w.device))
                for w in weights]

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        torch._foreach_mul_(grads, list((lrs / 2).unbind(0)))
        noise = self._noise(weights)
        torch._foreach_mul_(noise, list(torch.sqrt(lrs).unbind(0)))
        torch._foreach_sub_(weights, grads)
        torch._foreach_add_(weights, noise)


@register
class DCASGD(Optimizer):
    """Delay-compensated SGD: ``m = momentum * mom - lr * (g + wd * w +
    lamda * g² * (w - prev_w))``, ``w += m``, ``prev_w = w``; ``prev_w``
    starts as a copy of the weight."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lamda = lamda

    def create_state(self, index, weight):
        return (_zeros(weight), weight.detach().float().clone())

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        moms = [s[0] for s in states]
        prevs = [s[1] for s in states]
        comp = torch._foreach_sub(weights, prevs)
        torch._foreach_mul_(comp, torch._foreach_mul(grads, grads))
        torch._foreach_mul_(comp, self.lamda)
        torch._foreach_add_(comp, grads)
        torch._foreach_add_(comp, _wd_terms(weights, wds))
        torch._foreach_mul_(comp, list(lrs.unbind(0)))
        torch._foreach_mul_(moms, self.momentum)
        torch._foreach_sub_(moms, comp)
        torch._foreach_add_(weights, moms)
        torch._foreach_copy_(prevs, weights)


@register
class Adamax(Optimizer):
    """Adam in the infinity norm: ``u = max(beta2 * u, |g|)``, ``w -= lr /
    (1 - beta1^t) * m / (u + 1e-8)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2 = beta1, beta2

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        ms = [s[0] for s in states]
        us = [s[1] for s in states]
        lr_t = lrs / (1 - self.beta1 ** t)
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, grads, alpha=1 - self.beta1)
        torch._foreach_mul_(us, self.beta2)
        torch._foreach_maximum_(us, torch._foreach_abs(grads))
        denom = torch._foreach_add(us, 1e-8)
        step = torch._foreach_div(ms, denom)
        torch._foreach_mul_(step, _each(lr_t, len(weights)))
        torch._foreach_sub_(weights, step)


@register
class Nadam(Optimizer):
    """Adam with Nesterov momentum and the momentum schedule ``beta1 * (1 -
    0.5 * 0.96^(t * schedule_decay))``. The schedule's running product
    (``m_schedule``) advances once per parameter update, in index order, as
    the JAX package's eager update advances it: a float64 device scalar
    here, so a captured step advances it on the card."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self._m_schedule = None

    @property
    def m_schedule(self):
        """The running product on the host (a read of the card)."""
        return 1.0 if self._m_schedule is None else float(self._m_schedule)

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def _momentum(self, t, n, device):
        """(momentum at t, at t + 1): float64 device vectors of n."""
        t = t.double() if isinstance(t, torch.Tensor) else \
            torch.full((n,), float(t), dtype=torch.float64, device=device)
        t = t.expand(n)
        b1, sd = self.beta1, self.schedule_decay
        return (b1 * (1 - 0.5 * 0.96 ** (t * sd)),
                b1 * (1 - 0.5 * 0.96 ** ((t + 1) * sd)))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        n, device = len(weights), weights[0].device
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        if self._m_schedule is None:
            self._m_schedule = torch.ones((), dtype=torch.float64,
                                          device=device)
        mt, mt1 = self._momentum(t, n, device)
        sched = self._m_schedule * torch.cumprod(mt, 0)
        self._m_schedule.copy_(sched[-1])
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        g_prime = torch._foreach_div(grads, _each(
            (1 - sched).float(), n))
        torch._foreach_mul_(ms, self.beta1)
        torch._foreach_add_(ms, grads, alpha=1 - self.beta1)
        torch._foreach_mul_(vs, self.beta2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - self.beta2)
        m_prime = torch._foreach_div(ms, _each((1 - sched * mt1).float(), n))
        v_prime = torch._foreach_div(vs, _each(1 - self.beta2 ** t, n))
        torch._foreach_mul_(g_prime, _each((1 - mt).float(), n))
        torch._foreach_mul_(m_prime, _each(mt1.float(), n))
        m_bar = torch._foreach_add(g_prime, m_prime)
        denom = torch._foreach_sqrt(v_prime)
        torch._foreach_add_(denom, self.epsilon)
        step = torch._foreach_div(m_bar, denom)
        torch._foreach_mul_(step, list(lrs.unbind(0)))
        torch._foreach_sub_(weights, step)


@register
class RMSProp(Optimizer):
    """RMSProp: ``n = (1 - gamma1) g² + gamma1 n``, ``w -= lr * g /
    sqrt(n + eps)``; centred (Graves): also ``gm = (1 - gamma1) g + gamma1
    gm``, ``delta = gamma2 * delta - lr * g / sqrt(n - gm² + eps)``,
    ``w += delta``. ``clip_weights`` clips the result."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2, self.epsilon = gamma1, gamma2, epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight), _zeros(weight), _zeros(weight))
        return (_zeros(weight),)

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        g1 = self.gamma1
        ns = [s[0] for s in states]
        torch._foreach_mul_(ns, g1)
        torch._foreach_addcmul_(ns, grads, grads, value=1 - g1)
        step = torch._foreach_mul(grads, list(lrs.unbind(0)))
        if self.centered:
            gms = [s[1] for s in states]
            deltas = [s[2] for s in states]
            torch._foreach_mul_(gms, g1)
            torch._foreach_add_(gms, grads, alpha=1 - g1)
            denom = torch._foreach_sub(ns, torch._foreach_mul(gms, gms))
            torch._foreach_add_(denom, self.epsilon)
            torch._foreach_sqrt_(denom)
            torch._foreach_mul_(deltas, self.gamma2)
            torch._foreach_sub_(deltas, torch._foreach_div(step, denom))
            torch._foreach_add_(weights, deltas)
        else:
            denom = torch._foreach_add(ns, self.epsilon)
            torch._foreach_sqrt_(denom)
            torch._foreach_sub_(weights, torch._foreach_div(step, denom))
        if self.clip_weights:
            torch._foreach_clamp_min_(weights, -self.clip_weights)
            torch._foreach_clamp_max_(weights, self.clip_weights)


@register
class AdaGrad(Optimizer):
    """AdaGrad: ``h += g²``, ``w -= lr * g / sqrt(h + eps)``."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight)

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        torch._foreach_addcmul_(states, grads, grads)
        denom = torch._foreach_add(states, self.float_stable_eps)
        torch._foreach_sqrt_(denom)
        step = torch._foreach_mul(grads, list(lrs.unbind(0)))
        torch._foreach_sub_(weights, torch._foreach_div(step, denom))


@register
class AdaDelta(Optimizer):
    """AdaDelta (no learning rate): ``delta = sqrt(acc_delta + eps) /
    sqrt(acc_g + eps) * g``, ``w -= delta``."""

    def __init__(self, rho=0.9, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho, self.epsilon = rho, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        acc_g = [s[0] for s in states]
        acc_d = [s[1] for s in states]
        rho = self.rho
        torch._foreach_mul_(acc_g, rho)
        torch._foreach_addcmul_(acc_g, grads, grads, value=1 - rho)
        num = torch._foreach_add(acc_d, self.epsilon)
        torch._foreach_sqrt_(num)
        den = torch._foreach_add(acc_g, self.epsilon)
        torch._foreach_sqrt_(den)
        delta = torch._foreach_div(num, den)
        torch._foreach_mul_(delta, grads)
        torch._foreach_mul_(acc_d, rho)
        torch._foreach_addcmul_(acc_d, delta, delta, value=1 - rho)
        torch._foreach_sub_(weights, delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal: ``z += g - (sqrt(n + g²) - sqrt(n)) / lr * w``,
    ``n += g²``, ``w = (sign(z) * lamda1 - z) / ((beta + sqrt(n)) / lr +
    wd)`` where ``|z| > lamda1``, else 0."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1, self.beta = lamda1, beta

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        zs = [s[0] for s in states]
        ns = [s[1] for s in states]
        lr = list(lrs.unbind(0))
        sq_n = torch._foreach_sqrt(ns)
        torch._foreach_addcmul_(ns, grads, grads)
        sigma = torch._foreach_sqrt(ns)
        torch._foreach_sub_(sigma, sq_n)
        torch._foreach_div_(sigma, lr)
        torch._foreach_add_(zs, grads)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
        num = torch._foreach_sign(zs)
        torch._foreach_mul_(num, self.lamda1)
        torch._foreach_sub_(num, zs)
        den = torch._foreach_sqrt(ns)
        torch._foreach_add_(den, self.beta)
        torch._foreach_div_(den, lr)
        torch._foreach_add_(den, list(wds.unbind(0)))
        new = torch._foreach_div(num, den)
        torch._foreach_mul_(new, [(z.abs() > self.lamda1).float()
                                  for z in zs])
        torch._foreach_copy_(weights, new)


@register
class FTML(Optimizer):
    """Follow the moving leader: ``d_t = (1 - beta1^t) / lr * (sqrt(v / (1
    - beta2^t)) + eps)``, ``z = beta1 z + (1 - beta1) g - (d_t - beta1 d)
    w``, ``w = -z / d_t``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight), _zeros(weight))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        n = len(weights)
        torch._foreach_add_(grads, _wd_terms(weights, wds))
        ds = [s[0] for s in states]
        vs = [s[1] for s in states]
        zs = [s[2] for s in states]
        b1, b2 = self.beta1, self.beta2
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        d_t = torch._foreach_div(vs, _each(1 - b2 ** t, n))
        torch._foreach_sqrt_(d_t)
        torch._foreach_add_(d_t, self.epsilon)
        torch._foreach_mul_(d_t, _each((1 - b1 ** t) / lrs, n))
        sigma = torch._foreach_add(d_t, ds, alpha=-b1)
        torch._foreach_mul_(zs, b1)
        torch._foreach_add_(zs, grads, alpha=1 - b1)
        torch._foreach_sub_(zs, torch._foreach_mul(sigma, weights))
        torch._foreach_copy_(ds, d_t)
        torch._foreach_copy_(weights, torch._foreach_neg(
            torch._foreach_div(zs, d_t)))


@register
class LAMB(Optimizer):
    """Layer-wise adaptive moments: ``r = m̂ / (sqrt(v̂) + eps) + wd * w``
    with Adam's moments (bias-corrected at step ``t`` by default), then
    ``w -= lr * ratio * r`` with the trust ratio ``||w|| / ||r||`` (``||w||``
    clamped to ``lower_bound``/``upper_bound`` when set; 1 where either
    norm is 0), one norm per tensor."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-6, lower_bound=None, upper_bound=None,
                 bias_correction=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.lower_bound, self.upper_bound = lower_bound, upper_bound
        self.bias_correction = bias_correction

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        n = len(weights)
        b1, b2 = self.beta1, self.beta2
        ms = [s[0] for s in states]
        vs = [s[1] for s in states]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1 - b2)
        if self.bias_correction:
            mh = torch._foreach_div(ms, _each(1 - b1 ** t, n))
            vh = torch._foreach_div(vs, _each(1 - b2 ** t, n))
        else:
            mh, vh = ms, vs
        denom = torch._foreach_sqrt(vh)
        torch._foreach_add_(denom, self.epsilon)
        r = torch._foreach_div(mh, denom)
        torch._foreach_add_(r, _wd_terms(weights, wds))
        w_norm = _norms(weights)
        if self.lower_bound:
            w_norm = torch.clamp_min(w_norm, self.lower_bound)
        if self.upper_bound:
            w_norm = torch.clamp_max(w_norm, self.upper_bound)
        r_norm = _norms(r)
        ratio = torch.where((w_norm > 0) & (r_norm > 0), w_norm / r_norm,
                            torch.ones_like(w_norm))
        torch._foreach_mul_(r, list((lrs * ratio).unbind(0)))
        torch._foreach_sub_(weights, r)


@register
class LARS(SGD):
    """Layer-wise adaptive rate scaling: SGD on ``g * trust`` with ``trust
    = eta * ||w|| / (||g|| + wd * ||w|| + eps)`` (1 where either norm is
    0), one norm per tensor."""

    def __init__(self, eta=0.001, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.eta, self.epsilon = eta, epsilon

    def multi_update_rule(self, weights, grads, states, lrs, wds, t):
        w_norm = _norms(weights)
        g_norm = _norms(grads)
        trust = torch.where(
            (w_norm > 0) & (g_norm > 0),
            self.eta * w_norm / (g_norm + wds * w_norm + self.epsilon),
            torch.ones_like(w_norm))
        torch._foreach_mul_(grads, list(trust.unbind(0)))
        super().multi_update_rule(weights, grads, states, lrs, wds, t)


# ------------------------------------------------------------ Updater

class Updater:
    """One optimizer state per index: ``updater(index, grad, weight)``
    updates ``weight`` in place. ``get_states``/``set_states`` write and
    read the JAX package's pickle of numpy states (``{index: state}``,
    each state None, an array or a tuple of them)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        weight, grad = _tensor_of(weight), _tensor_of(grad)
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
        else:
            self.states[index] = _state_to(self.states[index], weight.device)
        new_state = self.optimizer.update_multi_precision(
            index, weight, grad, self.states[index])
        if new_state is not None:
            self.states[index] = new_state

    def get_states(self, dump_optimizer=False):
        """The states as a pickle; with ``dump_optimizer``, ``(states,
        info)``, info being the optimizer's class name and update counts
        as a plain dict (MXNet pickles the optimizer object itself; a dict
        keeps the file readable by both packages, and the JAX package
        reads the states alone)."""
        st = {k: _state_to_np(v) for k, v in self.states.items()}
        if not dump_optimizer:
            return pickle.dumps(st)
        opt = self.optimizer
        return pickle.dumps((st, dict(
            optimizer=type(opt).__name__, num_update=opt.num_update,
            index_update_count=dict(opt._index_update_count))))

    def set_states(self, states):
        """Load a ``get_states`` pickle (either package's); the states
        become host tensors until an update or ``Trainer.load_states``
        moves them. Update counts in the pickle are restored."""
        st = pickle.loads(states)
        info = None
        if isinstance(st, tuple):
            st, info = st[0], (st[1] if len(st) > 1 else None)
        self.states = {k: _state_from_np(v) for k, v in st.items()}
        self.states_synced = {k: False for k in self.states}
        if isinstance(info, dict) and "index_update_count" in info:
            opt = self.optimizer
            opt._index_update_count = dict(info["index_update_count"])
            opt.num_update = info["num_update"]


def _tensor_of(x):
    return x._data if hasattr(x, "_data") and not isinstance(
        x, torch.Tensor) else x


def _map_state(state, fn, *others):
    """``fn`` over a state's tensors (None, a tensor, or tuples and lists
    of them), tensor by tensor with the same places of ``others``; the
    results in the state's structure."""
    if isinstance(state, torch.Tensor):
        return fn(state, *others)
    if isinstance(state, (tuple, list)):
        return type(state)(_map_state(s, fn, *(o[i] for o in others))
                           for i, s in enumerate(state))
    return state


def _state_tensors(state):
    """A state with its NDArrays replaced by their tensors."""
    if isinstance(state, NDArray):
        return state._data
    if isinstance(state, (tuple, list)):
        return type(state)(_state_tensors(s) for s in state)
    return state


def _as_ndarrays(state):
    """A state of tensors as NDArrays over the same tensors."""
    return _map_state(state, NDArray)


def _state_to_np(s):
    """A state as numpy (bf16 widened to float32, as ``asnumpy`` does)."""
    if s is None:
        return None
    if isinstance(s, torch.Tensor):
        s = s.detach()
        if s.dtype == torch.bfloat16:
            s = s.float()
        return s.cpu().numpy().copy()
    if isinstance(s, (tuple, list)):
        return tuple(_state_to_np(x) for x in s)
    return s


def _state_from_np(s, device=None):
    """A numpy state as tensors (on ``device``, default the host)."""
    if s is None:
        return None
    if isinstance(s, onp.ndarray):
        return torch.from_numpy(s.copy()).to(device or "cpu")
    if isinstance(s, tuple):
        return tuple(_state_from_np(x, device) for x in s)
    return s


def _state_to(s, device):
    """A state's tensors on ``device`` (the same objects when there)."""
    if isinstance(s, torch.Tensor):
        return s if s.device == device else s.to(device)
    if isinstance(s, tuple):
        return tuple(_state_to(x, device) for x in s)
    return s


def get_updater(optimizer):
    return Updater(optimizer)
