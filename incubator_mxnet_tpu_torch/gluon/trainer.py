"""Gluon Trainer (counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``).

A ``Trainer`` owns an optimizer and one optimizer state per parameter,
keyed by the parameter's position in the list it was given (names are
structural only at the block level: every Dense's weight is "weight").
``step(batch_size)`` applies ``rescale_grad / batch_size`` and updates each
parameter from the gradient ``autograd.backward`` wrote (``Parameter.grad()``,
which the step leaves as it is), in place, through the optimizer's one
multi-tensor update (``Optimizer.update_all``) with its learning rates,
weight decays, steps and rescale as device tensors; ``jit.TrainStep`` runs
the same update on the gradients of its own backward (``_scalars`` then
``_apply``, which its CUDA graph captures).

``save_states``/``load_states`` write and read the JAX package's state
file (``Updater.get_states``: a pickle of numpy states by parameter
index), so a file written by either package loads in the other. The port
writes ``(states, info)``, info holding the optimizer's update counts; the
JAX package reads the states alone, and the port restores the counts when
a file has them (so a resumed run continues its bias correction and
``lr_scheduler``; a JAX package file restarts them, as there). Loaded
states land on each parameter's device as new tensors, so a captured
``jit.TrainStep`` captures again. Under ``TrainStep(mesh=, zero=True)``
the states are held in ZeRO-1 slices (``parallel.data_parallel``): the
update runs per slice and ``save_states`` gathers them.

Local only: ``kvstore`` "device", "local" or None. A "dist*" kvstore waits
for the multi-GPU slice of the port.
"""
from __future__ import annotations

import copy
import functools

import torch

from .. import autograd
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, (dict, ParameterDict)):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters")
        if isinstance(kvstore, str) and kvstore.startswith("dist"):
            raise NotImplementedError(
                "kvstore=%r comes with the multi-GPU slice of the port"
                % kvstore)
        if kvstore not in (None, "device", "local") or compression_params \
                or update_on_kvstore:
            raise NotImplementedError(
                "only a local kvstore ('device', 'local' or None) without "
                "compression or update_on_kvstore is ported")
        self._params = []
        for param in params:
            if not isinstance(param, Parameter):
                raise ValueError("First argument must contain Parameters, "
                                 "got %s" % type(param))
            self._params.append(param)
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise ValueError("optimizer_params must be None if optimizer "
                                 "is an Optimizer instance")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **(optimizer_params or {}))
        self._scale = self._optimizer.rescale_grad
        self._states = [None] * len(self._params)
        self._states_initialized = False
        self._zero = False      # states held in ZeRO-1 slices (parallel)

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    @property
    def optimizer(self):
        return self._optimizer

    def set_learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def _init_states(self):
        for i, param in enumerate(self._params):
            if param.grad_req != "null" and self._states[i] is None:
                self._states[i] = \
                    self._optimizer.create_state_multi_precision(
                        i, param._tensor())
        self._states_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient, scaled by
        ``rescale_grad / batch_size``."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` (with one local copy there is nothing to
        all-reduce first). A gradient no backward has written counts as
        zeros."""
        self._update(batch_size)

    def _live(self):
        """Indices of the parameters the update touches (grad_req not
        "null")."""
        return [i for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _scalars(self, batch_size, t=None):
        """Advance the update counts and return the step's host fp32
        vector ``[lrs, wds, ts, rescale]`` over the live parameters
        (``Optimizer.step_scalars``), with ``rescale_grad / batch_size``.
        ``t`` is Adam's bias-correction step for every parameter
        (``TrainStep`` passes its own step count); None takes each
        parameter's update count."""
        if not self._states_initialized:
            self._init_states()
        self._optimizer.rescale_grad = self._scale / batch_size
        return self._optimizer.step_scalars(self._live(), t)

    def _apply(self, grads, scalars):
        """``Optimizer.update_all`` of the live parameters from ``grads``
        (one per parameter, None for zeros) with ``scalars``, a
        ``_scalars`` vector on the parameters' device."""
        live = self._live()
        update = self._optimizer.update_all
        if self._zero:
            from ..parallel.data_parallel import zero_apply
            update = functools.partial(zero_apply, self._optimizer)
        update([self._params[i]._tensor() for i in live],
               [grads[i] for i in live], [self._states[i] for i in live],
               *self._optimizer.split_scalars(scalars))

    def _update(self, batch_size, t=None, grads=None, donate=True):
        """The update of ``step`` and ``jit.TrainStep``: every parameter
        from its gradient scaled by ``rescale_grad / batch_size``, in
        place. ``grads`` (one per parameter, None for zeros) replaces the
        parameters' own gradients; ``t`` as in ``_scalars``. With
        ``donate`` False the update writes new tensors and rebinds the
        parameters and states to them, so a tensor taken before the step
        keeps its values (``MXTPU_NO_DONATE``)."""
        scalars = self._scalars(batch_size, t)
        live = self._live()
        if not live:
            return
        if grads is None:
            grads = [None] * len(self._params)
            for i in live:
                grads[i] = autograd._grad_array(
                    self._params[i]._tensor())._data
        if not donate:
            for i in live:
                data = self._params[i]._tensor()
                data.data = data.detach().clone()
                self._states[i] = _clone(self._states[i])
        self._apply(grads, _upload(scalars,
                                   self._params[live[0]]._tensor().device))

    def allreduce_grads(self):
        """Nothing to reduce with one local copy of each parameter."""

    def save_states(self, fname):
        """Write every parameter's optimizer state and the optimizer's
        update counts to ``fname``."""
        if not self._states_initialized:
            self._init_states()
        updater = opt.Updater(self._optimizer)
        states = self._states
        if self._zero:
            from ..parallel.data_parallel import gathered
            states = [gathered(s) for s in states]
        updater.states = {i: s for i, s in enumerate(states)
                          if s is not None}
        with open(fname, "wb") as f:
            f.write(updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Read a ``save_states`` file (either package's): each state onto
        its parameter's device, and the update counts when it has them."""
        updater = opt.Updater(self._optimizer)
        with open(fname, "rb") as f:
            updater.set_states(f.read())
        self._init_states()
        for i, s in updater.states.items():
            i = int(i)
            self._states[i] = opt.optimizer._state_to(
                s, self._params[i]._tensor().device)
        self._zero = False      # whole again; a ZeRO-1 step splits them


def _upload(host, device):
    """The host tensor on ``device``; to a card through pinned memory, so
    the host does not wait for the card's queue."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


def _clone(state):
    """A copy of an optimizer state (None, a tensor, a ZeRO-1 slice set or
    nested tuples)."""
    if isinstance(state, (tuple, list)):
        return tuple(_clone(s) for s in state)
    if state is None:
        return None
    if not isinstance(state, torch.Tensor):       # parallel's ShardedState
        state = copy.copy(state)
        state.slices = [s.detach().clone() for s in state.slices]
        return state
    return state.detach().clone()
