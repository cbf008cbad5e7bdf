"""Checkpoints and the legacy ``FeedForward`` (counterpart of
``incubator_mxnet_tpu/model.py``).

A checkpoint is ``<prefix>-symbol.json`` (``Symbol.save``) and
``<prefix>-<epoch>.params``, an ``nd.save`` file whose keys are
``arg:<name>`` and ``aux:<name>``: the JAX package's files, which either
package reads. ``FeedForward`` is a thin veneer over ``Module``.
"""
from __future__ import annotations

import os

from . import ndarray as nd

__all__ = ["save_checkpoint", "load_checkpoint", "load_params", "BatchEndParam"]


class BatchEndParam:
    """What a batch-end callback gets: epoch, batch number, metric."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """Write ``<prefix>-symbol.json`` and ``<prefix>-%04d.params``."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)


def load_params(prefix, epoch):
    """(arg_params, aux_params) of ``<prefix>-%04d.params``."""
    save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params, aux_params = {}, {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if tp == "arg":
            arg_params[name] = v
        elif tp == "aux":
            aux_params[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint."""
    symbol = None
    sym_file = "%s-symbol.json" % prefix
    if os.path.exists(sym_file):
        from .symbol import load as sym_load
        symbol = sym_load(sym_file)
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class FeedForward:
    """The legacy training API over ``Module``; ``ctx`` None is the current
    context."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, begin_epoch=0, **kwargs):
        from . import initializer as init_mod
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer or init_mod.Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.begin_epoch = begin_epoch
        self._opt_kwargs = {k: v for k, v in kwargs.items()
                            if k in ("learning_rate", "momentum", "wd",
                                     "clip_gradient", "rescale_grad")}
        self._module = None

    def _mod(self):
        from .module import Module
        if self._module is None:
            self._module = Module(self.symbol, context=self.ctx)
        return self._module

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        """Train on ``X`` (an iterator, or arrays batched by
        ``numpy_batch_size`` with ``y``)."""
        from . import io as mx_io
        if not hasattr(X, "provide_data"):
            X = mx_io.NDArrayIter(X, y, batch_size=self.numpy_batch_size,
                                  shuffle=True)
        mod = self._mod()
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer, optimizer_params=self._opt_kwargs,
                initializer=self.initializer, arg_params=self.arg_params,
                aux_params=self.aux_params, begin_epoch=self.begin_epoch,
                num_epoch=self.num_epoch, monitor=monitor,
                eval_end_callback=eval_end_callback,
                eval_batch_end_callback=eval_batch_end_callback)
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def _ensure_ready(self, data_iter):
        """Bind and set the parameters for inference (load, then
        predict)."""
        mod = self._mod()
        if not mod.binded:
            mod.bind(data_shapes=data_iter.provide_data,
                     label_shapes=None, for_training=False)
        if not mod.params_initialized:
            if self.arg_params is None:
                raise ValueError("FeedForward has no parameters: call fit() "
                                 "or construct with arg_params")
            mod.set_params(self.arg_params, self.aux_params or {})
        return mod

    def predict(self, X, num_batch=None):
        """Outputs as numpy (a list for a symbol of several outputs)."""
        from . import io as mx_io
        import numpy as onp

        def to_np(o):
            return o.asnumpy() if hasattr(o, "asnumpy") else onp.asarray(o)

        if not hasattr(X, "provide_data"):
            X = mx_io.NDArrayIter(X, None, batch_size=self.numpy_batch_size)
        outs = self._ensure_ready(X).predict(X, num_batch=num_batch)
        if isinstance(outs, (list, tuple)):
            return to_np(outs[0]) if len(outs) == 1 else [to_np(o) for o in outs]
        return to_np(outs)

    def score(self, X, eval_metric="acc", num_batch=None):
        from . import metric as metric_mod
        m = metric_mod.create(eval_metric)
        res = self._ensure_ready(X).score(X, m, num_batch=num_batch)
        return dict(res)[m.name] if res else None

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None else
                        (self.num_epoch or 0), self.symbol,
                        self.arg_params or {}, self.aux_params or {})

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        from .symbol import load as sym_load
        sym = sym_load("%s-symbol.json" % prefix)
        arg, aux = load_params(prefix, epoch)
        return FeedForward(sym, ctx=ctx, arg_params=arg, aux_params=aux,
                           begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, optimizer="sgd",
               initializer=None, **kwargs):
        """Construct and fit."""
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            optimizer=optimizer, initializer=initializer,
                            **kwargs)
        return model.fit(X, y)
