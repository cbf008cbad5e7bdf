"""SVRG optimization (counterpart of ``incubator_mxnet_tpu/contrib/svrg.py``;
MXNet's ``contrib/svrg_optimization/svrg_module.py``).

Stochastic variance-reduced gradient: every ``update_freq`` epochs the
module copies its parameters into a snapshot module (w~) and takes the
full gradient mu over the epoch's data, the mean of the batches'
gradients; each step then updates with ``g_i(w) - g_i(w~) + mu``, an
unbiased gradient of lower variance. Both forward/backward passes are the
``Module``'s; the correction is written into the gradients in place.
"""
from __future__ import annotations

import logging

import torch

from ..module.module import Module

__all__ = ["SVRGModule"]


class SVRGModule(Module):
    """A ``Module`` with SVRG updates; ``update_freq`` epochs between full
    gradients."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 update_freq=2, **kwargs):
        super().__init__(symbol, data_names=data_names,
                         label_names=label_names, logger=logger,
                         context=context, **kwargs)
        assert update_freq >= 1
        self.update_freq = update_freq
        self._mod_aux = Module(symbol, data_names=data_names,
                               label_names=label_names, logger=logger,
                               context=context, **kwargs)
        self._mu = None     # the full gradient, {name: NDArray}

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        super().bind(data_shapes, label_shapes, for_training,
                     inputs_need_grad, force_rebind, shared_module, grad_req)
        self._mod_aux.bind(data_shapes, label_shapes, for_training,
                           inputs_need_grad, force_rebind, None, grad_req)

    def init_params(self, *args, **kwargs):
        super().init_params(*args, **kwargs)
        arg, aux = self.get_params()
        self._mod_aux.set_params(arg, aux)

    def update_full_grads(self, train_data):
        """Copy the parameters into the snapshot module and take mu, the
        mean of its parameter gradients over every batch of
        ``train_data``."""
        arg, aux = self.get_params()
        self._mod_aux.set_params(arg, aux)
        train_data.reset()
        params = set(self._mod_aux.param_names)
        sums, nbatch = {}, 0
        for batch in train_data:
            self._mod_aux.forward(batch, is_train=True)
            self._mod_aux.backward()
            for name, g in self._mod_aux._exec.grad_dict.items():
                if g is None or name not in params:
                    continue
                sums[name] = g.copy() if name not in sums else sums[name] + g
            nbatch += 1
        self._mu = {k: v / nbatch for k, v in sums.items()}

    def forward_backward(self, data_batch):
        """The module's forward and backward, then (once mu exists) the
        snapshot's on the same batch: each gradient becomes
        ``g - g~ + mu``."""
        super().forward_backward(data_batch)
        if self._mu is None:
            return          # before the first full gradient: a plain step
        self._mod_aux.forward(data_batch, is_train=True)
        self._mod_aux.backward()
        params = set(self.param_names)
        with torch.no_grad():
            for name, g in self._exec.grad_dict.items():
                if g is None or name not in self._mu or name not in params:
                    continue
                g_tilde = self._mod_aux._exec.grad_dict.get(name)
                if g_tilde is not None:
                    g._data.copy_(
                        (g._data - g_tilde._data) + self._mu[name]._data)

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),), initializer=None,
            arg_params=None, aux_params=None, allow_missing=False,
            force_rebind=False, force_init=False, begin_epoch=0,
            num_epoch=None, validation_metric=None, monitor=None, **kwargs):
        """MXNet's training loop with a full-gradient pass every
        ``update_freq`` epochs."""
        from .. import initializer as init_mod
        from .. import metric as metric_mod
        assert num_epoch is not None
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        self.init_params(initializer=initializer or init_mod.Uniform(0.01),
                         arg_params=arg_params, aux_params=aux_params,
                         allow_missing=allow_missing, force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        for epoch in range(begin_epoch, num_epoch):
            if epoch % self.update_freq == 0:
                self.update_full_grads(train_data)
            eval_metric.reset()
            train_data.reset()
            for data_batch in train_data:
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            if eval_data is not None:
                for name, val in self.score(eval_data, eval_metric):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
