"""BaseModule: the symbolic training API (counterpart of
``incubator_mxnet_tpu/module/base_module.py``).

``fit`` is MXNet's epoch/batch loop: bind, init_params, init_optimizer,
then forward_backward / update / update_metric per batch, the batch-end
callbacks, and the epoch-end callbacks (checkpoints) with the parameters.
Over a "dist_async" kvstore each epoch starts with the store's
``begin_epoch`` (the iterator's length, 0 without one) and ends with its
``sync``.
"""
from __future__ import annotations

import logging
import time

from .. import metric as metric_mod
from .. import ndarray as nd
from ..model import BatchEndParam

__all__ = ["BaseModule"]


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.symbol = None

    # ---- things subclasses implement --------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True, **kw):
        raise NotImplementedError

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=None, force_init=False):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    # ---- composite helpers ------------------------------------------
    def forward_backward(self, data_batch):
        """A training forward, then the backward."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, batch_end_callback=None,
              reset=True, epoch=0, sparse_row_id_fn=None):
        """Run ``eval_data`` through the model and return the metric's
        (name, value) pairs."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            self.update_metric(eval_metric, eval_batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch, nbatch, eval_metric)
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True, reset=True,
                always_output_list=False):
        """The outputs over ``eval_data``, each batch's pad dropped, merged
        along the batch axis."""
        assert self.binded and self.params_initialized
        if reset:
            eval_data.reset()
        output_list = []
        for nbatch, eval_batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(eval_batch, is_train=False)
            pad = eval_batch.pad or 0
            outs = [o[: o.shape[0] - pad] for o in self.get_outputs()]
            output_list.append(outs)
        if not output_list:
            return []
        if merge_batches:
            num_outputs = len(output_list[0])
            merged = [nd.concatenate([o[i] for o in output_list], axis=0)
                      for i in range(num_outputs)]
            if num_outputs == 1 and not always_output_list:
                return merged[0]
            return merged
        return output_list

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None, monitor=None,
            sparse_row_id_fn=None):
        """Train for ``num_epoch`` epochs (MXNet's loop)."""
        assert num_epoch is not None, "please specify number of epochs"
        from .. import initializer as init_mod

        if initializer is None:
            initializer = init_mod.Uniform(0.01)
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label, for_training=True,
                  force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=dict(optimizer_params))
        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        # dist_async's epoch contract (DistAsyncKVStore): agree on the
        # averaging rounds at each epoch's start, average at its end
        kv = getattr(self, "_kvstore", None)
        kv_async = kv is not None and hasattr(kv, "begin_epoch")
        for epoch in range(begin_epoch, num_epoch):
            tic = time.perf_counter()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            if kv_async:
                try:
                    planned = len(train_data)
                except TypeError:
                    planned = 0
                # a collective: a worker with an empty shard joins it too
                kv.begin_epoch(planned)
            for data_batch in train_data:
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                self.update_metric(eval_metric, data_batch.label)
                if monitor is not None:
                    monitor.toc_print()
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch, nbatch, eval_metric)
                    for cb in _as_list(batch_end_callback):
                        cb(param)
                nbatch += 1
            if kv_async:
                kv.sync()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.perf_counter() - tic)
            if epoch_end_callback is not None:
                arg_params, aux_params = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_params, aux_params)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch, name, val)

    def install_monitor(self, monitor):
        """Have ``monitor`` read this module's executors."""
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError


def _as_list(obj):
    if isinstance(obj, (list, tuple)):
        return obj
    return [obj]
