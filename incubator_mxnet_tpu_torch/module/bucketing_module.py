"""BucketingModule: variable-length input through one Module per bucket key
(counterpart of ``incubator_mxnet_tpu/module/bucketing_module.py``).

``sym_gen(bucket_key)`` gives each bucket's symbol. As in MXNet, every
bucket binds with the default bucket's module as ``shared_module``: the
buckets hold the same parameter tensors, the same gradient buffers, the
same optimizer and the same optimizer states, so there is one parameter
set however many buckets run (the JAX package copies the parameters into a
bucket when it switches to it and gives each bucket its own states).
"""
from __future__ import annotations

import logging

from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, **kwargs):
        super().__init__(logger)
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._kwargs = kwargs
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    @symbol.setter
    def symbol(self, v):
        pass

    def _gen_module(self, bucket_key):
        if bucket_key not in self._buckets:
            sym, data_names, label_names = self._sym_gen(bucket_key)
            mod = Module(sym, data_names, label_names, self.logger,
                         self._context, **self._kwargs)
            self._buckets[bucket_key] = mod
        return self._buckets[bucket_key]

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             force_rebind=False, **kw):
        self._curr_module = self._gen_module(self._default_bucket_key)
        self._curr_bucket_key = self._default_bucket_key
        self._curr_module.bind(data_shapes, label_shapes, for_training,
                               force_rebind=force_rebind)
        self.binded = True
        self.for_training = for_training

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` current, binding its module on the default
        bucket's parameters the first time."""
        mod = self._gen_module(bucket_key)
        if not mod.binded:
            mod.bind(data_shapes, label_shapes, self.for_training,
                     shared_module=self._buckets[self._default_bucket_key])
        self._curr_module = mod
        self._curr_bucket_key = bucket_key

    def init_params(self, *args, **kwargs):
        self._curr_module.init_params(*args, **kwargs)
        self.params_initialized = True

    def get_params(self):
        return self._curr_module.get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._curr_module.set_params(arg_params, aux_params, **kwargs)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        self._curr_module.init_optimizer(kvstore, optimizer, optimizer_params,
                                         force_init)
        for mod in self._buckets.values():
            if mod is not self._curr_module and mod.binded:
                mod._optimizer = self._curr_module._optimizer
                mod._kvstore = self._curr_module._kvstore
                mod._updater_states = self._curr_module._updater_states
                mod._update_on_kvstore = False
                mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = getattr(data_batch, "bucket_key", self._curr_bucket_key)
        if key != self._curr_bucket_key:
            self.switch_bucket(key, data_batch.provide_data,
                               data_batch.provide_label)
        self._curr_module.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, monitor):
        for mod in self._buckets.values():
            if mod.binded:
                mod.install_monitor(monitor)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._curr_module.save_checkpoint(prefix, epoch, save_optimizer_states)
