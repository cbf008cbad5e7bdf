"""Gluon's Estimator (counterpart of
``incubator_mxnet_tpu/gluon/contrib/estimator.py``; MXNet's
``gluon/contrib/estimator/{estimator,event_handler}.py``): a fit loop that
calls event handlers.

The six event bases (``TrainBegin``, ``TrainEnd``, ``EpochBegin``,
``EpochEnd``, ``BatchBegin``, ``BatchEnd``) mark what a handler listens
to. ``Estimator.fit`` runs the net and the loss under ``autograd.record``
per batch, the backward, ``trainer.step(batch size)``, then the batch-end
handlers (a true return stops the epoch); ``StoppingHandler`` (epochs,
batches) and ``MetricHandler`` (the training metrics) are added to the
caller's. ``evaluate`` runs the net over a loader and updates the
metrics. ``ValidationHandler``, ``LoggingHandler``, ``CheckpointHandler``
and ``EarlyStoppingHandler`` are MXNet's.
"""
from __future__ import annotations

import logging
import os
import time

from ... import autograd
from ... import metric as metric_mod

__all__ = ["Estimator", "TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd",
           "BatchBegin", "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stops after ``max_epoch`` epochs or ``max_batch`` batches."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch and self.current_batch == self.max_batch:
            self.stop_training = True
        return self.stop_training

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch and self.current_epoch == self.max_epoch:
            self.stop_training = True
        return self.stop_training


class MetricHandler(EpochBegin, BatchEnd):
    """Resets the training metrics each epoch and updates them each batch
    (a ``metric.Loss`` from the loss, the others from label and
    prediction)."""

    def __init__(self, train_metrics):
        self.train_metrics = train_metrics or []

    def epoch_begin(self, estimator, *args, **kwargs):
        for m in self.train_metrics:
            m.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred, label, loss = kwargs["pred"], kwargs["label"], kwargs["loss"]
        for m in self.train_metrics:
            if isinstance(m, metric_mod.Loss):
                m.update(0, loss)
            else:
                m.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """``eval_fn(val_data=...)`` every ``epoch_period`` epochs and every
    ``batch_period`` batches."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchBegin,
                     BatchEnd):
    """Logs the training's and each epoch's time and ``metrics``, and
    every ``log_interval`` batches when it is an int."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.perf_counter()
        logging.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        logging.info("Train finished using total %ds",
                     time.perf_counter() - self.train_start)
        for m in self.metrics:
            name, value = m.get()
            logging.info("Train end: %s: %.4f", name, value)

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int):
            self.batch_index += 1
            if self.batch_index % self.log_interval == 0:
                msg = "[Epoch %d][Batch %d]" % (self.current_epoch,
                                                self.batch_index)
                for m in self.metrics:
                    name, value = m.get()
                    msg += " %s: %.4f" % (name, value)
                logging.info(msg)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.perf_counter()

    def epoch_end(self, estimator, *args, **kwargs):
        msg = "[Epoch %d] finished in %.3fs:" % (
            self.current_epoch, time.perf_counter() - self.epoch_start)
        for m in self.metrics:
            name, value = m.get()
            msg += " %s: %.4f" % (name, value)
        logging.info(msg)
        self.current_epoch += 1
        self.batch_index = 0


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """``<model_dir>/<model_prefix>-epoch<n>.params`` every
    ``epoch_period`` epochs."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.epoch_period = epoch_period
        self.current_epoch = 0
        os.makedirs(model_dir, exist_ok=True)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            estimator.net.save_parameters(os.path.join(
                self.model_dir, "%s-epoch%d.params"
                % (self.model_prefix, self.current_epoch)))


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stops once ``monitor`` has not fallen by ``min_delta`` for
    ``patience`` epochs."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.wait = 0
        self.best = None
        self.stop_training = False

    def epoch_end(self, estimator, *args, **kwargs):
        _, current = self.monitor.get()
        if self.best is None or current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stop_training = True
        return self.stop_training


class Estimator:
    """``fit`` / ``evaluate`` of ``net`` under ``loss`` with ``trainer``
    (the training metrics default to ``Accuracy``)."""

    def __init__(self, net, loss, train_metrics=None, trainer=None,
                 context=None):
        self.net = net
        self.loss = loss
        self.train_metrics = train_metrics \
            if isinstance(train_metrics, list) else (
                [train_metrics] if train_metrics else [metric_mod.Accuracy()])
        self.trainer = trainer
        self.train_loss_metric = metric_mod.Loss("train_loss")

    def evaluate(self, val_data, val_metrics=None):
        """The metrics (default: the training ones) over ``val_data``."""
        val_metrics = val_metrics or self.train_metrics
        for m in val_metrics:
            m.reset()
        for batch in val_data:
            data, label = batch[0], batch[1]
            pred = self.net(data)
            for m in val_metrics:
                m.update([label], [pred])
        return val_metrics

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None):
        """Train until ``epochs`` epochs or ``batches`` batches (or a
        handler) stop it."""
        handlers = list(event_handlers or [])
        stop_handler = StoppingHandler(epochs, batches)
        handlers.append(stop_handler)
        handlers.append(MetricHandler(self.train_metrics))
        for h in handlers:
            if isinstance(h, TrainBegin):
                h.train_begin(self)
        while not stop_handler.stop_training:
            for h in handlers:
                if isinstance(h, EpochBegin):
                    h.epoch_begin(self)
            for batch in train_data:
                data, label = batch[0], batch[1]
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                self.trainer.step(data.shape[0])
                self.train_loss_metric.update(0, [loss])
                stop = False
                for h in handlers:
                    if isinstance(h, BatchEnd) and h.batch_end(
                            self, pred=[pred], label=[label], loss=[loss]):
                        stop = True
                if stop or stop_handler.stop_training:
                    break
            for h in handlers:
                if isinstance(h, EpochEnd):
                    h.epoch_end(self)
        for h in handlers:
            if isinstance(h, TrainEnd):
                h.train_end(self)
