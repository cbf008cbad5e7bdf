"""Gluon Trainer (counterpart of ``incubator_mxnet_tpu/gluon/trainer.py``).

A ``Trainer`` owns an optimizer and one optimizer state per parameter,
keyed by the parameter's position in the list it was given (names are
structural only at the block level: every Dense's weight is "weight").
``step(batch_size)`` applies ``rescale_grad / batch_size`` and updates each
parameter from its gradient, in place; ``jit.TrainStep`` runs the same
update loop inside one call.

Local only: ``kvstore`` "device", "local" or None. A "dist*" kvstore waits
for the multi-GPU slice of the port; ``save_states`` and ``load_states``
are not ported yet.
"""
from __future__ import annotations

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
                        i, param.data())
        self._states_initialized = True

    def step(self, batch_size, ignore_stale_grad=False):
        """Update every parameter from its gradient, scaled by
        ``rescale_grad / batch_size``."""
        self.update(batch_size, ignore_stale_grad)

    def update(self, batch_size, ignore_stale_grad=False):
        """The update of ``step`` (with one local copy there is nothing to
        all-reduce first). A parameter with ``grad_req="write"`` has its
        gradient consumed: the next backward writes it afresh, as MXNet's
        "write" does. A missing gradient counts as zeros."""
        self._update(batch_size)
        for param in self._params:
            if param.grad_req == "write":
                param.zero_grad()

    def _update(self, batch_size, t=None):
        """The update loop of ``step`` and ``jit.TrainStep``: every
        parameter from its gradient scaled by ``rescale_grad / batch_size``,
        in place. ``t`` is Adam's bias-correction step for every parameter
        (``TrainStep`` passes its own step count); None takes each
        parameter's update count."""
        if not self._states_initialized:
            self._init_states()
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, param in enumerate(self._params):
            if param.grad_req == "null":
                continue
            data = param.data()
            self._states[i] = self._optimizer.update_multi_precision(
                i, data, data.grad, self._states[i], t)

    def allreduce_grads(self):
        """Nothing to reduce with one local copy of each parameter."""
