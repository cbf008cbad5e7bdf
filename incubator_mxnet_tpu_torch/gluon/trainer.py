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

``kvstore`` "device", "local" or None updates locally, as above (a local
store's compression is never used: nothing is pushed into it, as in the
JAX package). A "dist*" store (a name or a ``KVStore``), or
``update_on_kvstore=True``, goes the JAX package's way through the store,
made at the first step: ``compression_params`` are set on it, every
parameter is ``init``-ed into it (rank 0's values reach every process),
and ``update_on_kvstore`` defaults to True for "dist*". Then each step
sets ``rescale_grad / batch_size`` on the optimizer, pushes each
gradient (``push(i, grad, priority=-i)``: the store sums it over the
processes and runs its updater, which keeps fp32 masters under
``multi_precision`` as the local path does) and pulls each parameter back
(``pull(i, data)``). The store sums over the processes and does not
average: with n workers each at batch b, the update sees the n·b samples'
gradient sum over b. ``save_states``/``load_states`` then read and write
the store's updater. With ``update_on_kvstore=False`` a dist store sums
the gradients (``pushpull`` into each gradient) and the update runs
locally, as MXNet's Trainer does (the JAX package's skips the sum there).
A ``jit.TrainStep`` runs its own update and refuses a trainer that updates
through a store.
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
        self._compression_params = compression_params
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = False

    def _init_kvstore(self):
        """Make the store when the step goes through one (see the module
        docstring); the local path keeps none."""
        from .. import kvstore as kvs_mod
        kvstore = self._kvstore_params["kvstore"]
        update = self._kvstore_params["update_on_kvstore"]
        name = kvstore if isinstance(kvstore, str) else \
            getattr(kvstore, "type", "")
        self._kv_initialized = True
        if kvstore is None or not (name.startswith("dist") or update):
            return
        kv = kvs_mod.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        if self._compression_params:
            kv.set_gradient_compression(self._compression_params)
        self._update_on_kvstore = name.startswith("dist") \
            if update is None else bool(update)
        if self._update_on_kvstore:
            kv.set_optimizer(self._optimizer)
        for i, param in enumerate(self._params):
            if param.grad_req != "null":
                kv.init(i, param.data())
        self._kvstore = kv

    def _store(self):
        """The store the update goes through (made at first use), or
        None."""
        if not self._kv_initialized:
            self._init_kvstore()
        return self._kvstore

    def _refuse_kvstore(self, what):
        """Raise if the update goes through a store (``what`` runs its own
        update)."""
        if self._store() is not None:
            raise NotImplementedError(
                "%s runs the update itself; this Trainer updates through its "
                "%r kvstore: call Trainer.step" % (what, self._kvstore.type))

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
        ``rescale_grad / batch_size`` (through the store with a dist
        kvstore: the module docstring)."""
        if self._store() is None:
            return self._update(batch_size)
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._kv_update(batch_size)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` without its push (after
        ``allreduce_grads``; with one local copy there is nothing to
        reduce first). A gradient no backward has written counts as
        zeros."""
        if self._store() is None:
            return self._update(batch_size)
        self._optimizer.rescale_grad = self._scale / batch_size
        self._kv_update(batch_size)

    def _allreduce_grads(self):
        """Push every live gradient into the store (``priority=-i``); with
        ``update_on_kvstore`` False, pull the sums back into the
        gradients."""
        kv = self._kvstore
        for i in self._live():
            kv.push(i, self._params[i].grad(), priority=-i)
            if not self._update_on_kvstore:
                kv.pull(i, self._params[i].grad(), priority=-i)

    def _kv_update(self, batch_size):
        if self._update_on_kvstore:
            for i in self._live():
                self._kvstore.pull(i, self._params[i].data(), priority=-i)
        else:
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
        """Push the gradients into a dist store (nothing to reduce with one
        local copy of each parameter)."""
        if self._store() is not None:
            self._allreduce_grads()

    def save_states(self, fname):
        """Write every parameter's optimizer state and the optimizer's
        update counts to ``fname`` (the store's updater's, when the update
        runs in the store)."""
        if self._store() is not None and self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
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
        if self._store() is not None and self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            return
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
