"""Evaluation metrics (counterpart of ``incubator_mxnet_tpu/metric.py``).

The metrics of a training loop reduce on the predictions' device:
``Accuracy``, ``Perplexity``, ``CrossEntropy`` /
``NegativeLogLikelihood``, ``Loss``, ``MAE``, ``MSE`` and ``RMSE`` keep
their sums there as float64 tensors and their counts on the host (counts
follow from shapes), so an update copies nothing to the host; ``get()``
is the one host read. The JAX package copies every prediction to the host
(``_as_np``), which at BERT's (64, 512, 32768) logits is 2.1 GB a batch.
``F1``, ``MCC``, ``PearsonCorrelation`` and ``CustomMetric`` take small
host copies, as there, and so does ``TopKAccuracy``: which of several
equal predictions count among the top k is NumPy's ``argpartition``'s
choice in the JAX package (and in MXNet), an order no device sort
reproduces. ``Perplexity`` and ``RMSE`` apply their ``exp`` and
square root in ``get_global`` too, as MXNet does (the JAX package's
``get_global`` gives the mean negative log-likelihood and the MSE).

Inputs may be NDArrays, tensors or numpy arrays.
"""
from __future__ import annotations

import math

import numpy as onp
import torch

from .base import registry
from .ndarray import NDArray

__all__ = ["EvalMetric", "CompositeEvalMetric", "Accuracy", "TopKAccuracy",
           "F1", "MCC", "Perplexity", "MAE", "MSE", "RMSE", "CrossEntropy",
           "NegativeLogLikelihood", "PearsonCorrelation", "Loss", "Torch",
           "Caffe", "CustomMetric", "np", "create", "register"]

_REG = registry("metric")


def _as_np(x):
    """A host copy (for the metrics that take one)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    return onp.asarray(x)


def _as_tensor(x, device=None):
    """``x`` as a detached tensor (on ``device`` for a host array)."""
    if isinstance(x, NDArray):
        x = x._data
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.as_tensor(onp.asarray(x), device=device)


def check_label_shapes(labels, preds, wrap=False, shape=False):
    if not shape:
        lshape, pshape = len(labels), len(preds)
    else:
        lshape, pshape = tuple(labels.shape), tuple(preds.shape)
    if lshape != pshape:
        raise ValueError("Shape of labels %s does not match shape of "
                         "predictions %s" % (lshape, pshape))
    if wrap:
        if isinstance(labels, (NDArray, torch.Tensor)):
            labels = [labels]
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
    return labels, preds


class EvalMetric:
    """Base metric with local and global sums. A sum is a host float or a
    float64 device tensor; ``get()`` reads it."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0
        self.global_num_inst = 0
        self.global_sum_metric = 0.0

    def reset_local(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[n] for n in self.output_names if n in pred]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[n] for n in self.label_names if n in label]
        else:
            label = list(label.values())
        self.update(label, pred)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, float(self.sum_metric) / self.num_inst)

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name,
                float(self.global_sum_metric) / self.global_num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def _add(self, metric, inst):
        """Add ``metric`` (a host number, or a device tensor kept there in
        float64) over ``inst`` instances."""
        if isinstance(metric, torch.Tensor):
            metric = metric.detach().double()
        self.sum_metric = self.sum_metric + metric
        self.num_inst += inst
        self.global_sum_metric = self.global_sum_metric + metric
        self.global_num_inst += inst

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


class CompositeEvalMetric(EvalMetric):
    """Several metrics updated together; ``get()`` gives lists."""

    def __init__(self, metrics=None, name="composite", **kw):
        super().__init__(name, **kw)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        super().reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            values.append(v)
        return names, values


def register(klass):
    return _REG.register(klass)


@register
class Accuracy(EvalMetric):
    """Share of predictions (the argmax over ``axis`` when ``pred`` has
    more dimensions than ``label``) equal to the label."""

    def __init__(self, axis=1, name="accuracy", **kw):
        super().__init__(name, axis=axis, **kw)
        self.axis = axis

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _as_tensor(pred)
            lab = _as_tensor(label, p.device).to(p.device)
            if p.dim() > lab.dim():
                p = p.argmax(dim=self.axis)
            p = p.to(torch.int32).flatten()
            lab = lab.to(torch.int32).flatten()
            check_label_shapes(lab, p, shape=True)
            self._add((p == lab).sum(), p.numel())


@register
class TopKAccuracy(EvalMetric):
    """Share of labels among the ``top_k`` largest predictions, ties
    broken as NumPy's ``argpartition`` breaks them (on a host copy)."""

    def __init__(self, top_k=1, name="top_k_accuracy", **kw):
        super().__init__(name + "_%d" % top_k, top_k=top_k, **kw)
        self.top_k = top_k

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p, lab = _as_np(pred), _as_np(label).astype("int32")
            idx = onp.argpartition(p, -self.top_k, axis=-1)[
                ..., -self.top_k:]
            hit = (idx == lab[..., None]).any(axis=-1)
            self._add(float(hit.sum()), hit.size)


@register
class F1(EvalMetric):
    """Binary F1 over every batch so far (a host computation)."""

    def __init__(self, name="f1", average="macro", **kw):
        super().__init__(name, **kw)
        self.average = average
        self._tp = self._fp = self._fn = 0.0

    def reset(self):
        self._tp = self._fp = self._fn = 0.0
        super().reset()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            lab = _as_np(label).astype("int32").flatten()
            if p.ndim > 1 and p.shape[-1] > 1:
                p = p.argmax(axis=-1)
            else:
                p = (p.flatten() > 0.5).astype("int32")
            p = p.astype("int32").flatten()
            self._tp += float(((p == 1) & (lab == 1)).sum())
            self._fp += float(((p == 1) & (lab == 0)).sum())
            self._fn += float(((p == 0) & (lab == 1)).sum())
            prec = self._tp / (self._tp + self._fp) \
                if self._tp + self._fp else 0.0
            rec = self._tp / (self._tp + self._fn) \
                if self._tp + self._fn else 0.0
            f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
            self.sum_metric = f1
            self.num_inst = 1
            self.global_sum_metric = f1
            self.global_num_inst = 1


@register
class MCC(EvalMetric):
    """Matthews correlation coefficient over every batch so far (a host
    computation)."""

    def __init__(self, name="mcc", **kw):
        super().__init__(name, **kw)
        self._tp = self._fp = self._fn = self._tn = 0.0

    def reset(self):
        self._tp = self._fp = self._fn = self._tn = 0.0
        super().reset()

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _as_np(pred)
            lab = _as_np(label).astype("int32").flatten()
            if p.ndim > 1 and p.shape[-1] > 1:
                p = p.argmax(axis=-1)
            else:
                p = p.flatten() > 0.5
            p = p.astype("int32").flatten()
            self._tp += float(((p == 1) & (lab == 1)).sum())
            self._fp += float(((p == 1) & (lab == 0)).sum())
            self._fn += float(((p == 0) & (lab == 1)).sum())
            self._tn += float(((p == 0) & (lab == 0)).sum())
            num = self._tp * self._tn - self._fp * self._fn
            den = math.sqrt((self._tp + self._fp) * (self._tp + self._fn)
                            * (self._tn + self._fp) * (self._tn + self._fn))
            mcc = num / den if den else 0.0
            self.sum_metric = mcc
            self.num_inst = 1
            self.global_sum_metric = mcc
            self.global_num_inst = 1


def _picked(pred, label):
    """(the predicted probability of each label, flattened, the labels):
    a gather on the predictions' device."""
    p = _as_tensor(pred)
    lab = _as_tensor(label, p.device).to(p.device, torch.int64).flatten()
    p = p.reshape(-1, p.shape[-1])
    return p.gather(1, lab[:, None])[:, 0], lab


@register
class Perplexity(EvalMetric):
    """``exp`` of the mean negative log of the label's probability
    (``pred`` holds probabilities), skipping ``ignore_label``."""

    def __init__(self, ignore_label=None, axis=-1, name="perplexity", **kw):
        super().__init__(name, **kw)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        """The count is a device tensor when labels are ignored (how many
        is known on the card only)."""
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            probs, lab = _picked(pred, label)
            probs = probs.double()
            if self.ignore_label is not None:
                ignore = lab == self.ignore_label
                probs = torch.where(ignore, torch.ones_like(probs), probs)
                num = num - ignore.sum()
            loss = loss - torch.log(torch.clamp_min(probs, 1e-10)).sum()
            num = num + lab.numel()
        self._add(loss, num)

    def get(self):
        if float(self.num_inst) == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(float(self.sum_metric)
                                    / float(self.num_inst)))

    def get_global(self):
        if float(self.global_num_inst) == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(float(self.global_sum_metric)
                                    / float(self.global_num_inst)))


def _label_like(label, p):
    """The label as a float64 tensor on ``p``'s device, a column when it is
    1-D and ``p`` is not (the JAX package's reshape)."""
    lab = _as_tensor(label, p.device).to(p.device, torch.float64)
    if lab.dim() == 1 and p.dim() != 1:
        lab = lab.reshape(lab.shape[0], 1)
    return lab


@register
class MAE(EvalMetric):
    """Mean absolute error, averaged per batch."""

    def __init__(self, name="mae", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _as_tensor(pred).double()
            self._add((_label_like(label, p) - p).abs().mean(), 1)


@register
class MSE(EvalMetric):
    """Mean squared error, averaged per batch."""

    def __init__(self, name="mse", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p = _as_tensor(pred).double()
            self._add(((_label_like(label, p) - p) ** 2).mean(), 1)


@register
class RMSE(MSE):
    """The square root of ``MSE``."""

    def __init__(self, name="rmse", **kw):
        EvalMetric.__init__(self, name, **kw)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(float(self.sum_metric)
                                     / self.num_inst))

    def get_global(self):
        if self.global_num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(float(self.global_sum_metric)
                                     / self.global_num_inst))


@register
class CrossEntropy(EvalMetric):
    """Mean ``-log(p[label] + eps)``."""

    def __init__(self, eps=1e-12, name="cross-entropy", **kw):
        super().__init__(name, **kw)
        self.eps = eps

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            prob, lab = _picked(pred, label)
            self._add((-torch.log(prob.double() + self.eps)).sum(),
                      lab.numel())


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", **kw):
        EvalMetric.__init__(self, name, **kw)
        self.eps = eps


@register
class PearsonCorrelation(EvalMetric):
    """Pearson's r per batch, averaged (a host computation)."""

    def __init__(self, name="pearsonr", **kw):
        super().__init__(name, **kw)

    def update(self, labels, preds):
        labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            p, lab = _as_np(pred).ravel(), _as_np(label).ravel()
            self._add(float(onp.corrcoef(p, lab)[0, 1]), 1)


@register
class Loss(EvalMetric):
    """The mean of the predictions (a loss passed as the prediction)."""

    def __init__(self, name="loss", **kw):
        super().__init__(name, **kw)

    def update(self, _, preds):
        if isinstance(preds, (NDArray, torch.Tensor)):
            preds = [preds]
        for pred in preds:
            p = _as_tensor(pred)
            self._add(p.double().sum(), p.numel())


@register
class Torch(Loss):
    def __init__(self, name="torch", **kw):
        EvalMetric.__init__(self, name, **kw)


@register
class Caffe(Loss):
    def __init__(self, name="caffe", **kw):
        EvalMetric.__init__(self, name, **kw)


# MXNet's aliases
_REG.register(Accuracy, "acc")
_REG.register(TopKAccuracy, "top_k_acc")
_REG.register(TopKAccuracy, "top_k_accuracy")
_REG.register(CrossEntropy, "ce")
_REG.register(NegativeLogLikelihood, "nll_loss")
_REG.register(PearsonCorrelation, "pearsonr")


class CustomMetric(EvalMetric):
    """``feval(label, pred)`` on host copies: a value, or (sum, count)."""

    def __init__(self, feval, name=None, allow_extra_outputs=False, **kw):
        name = name if name is not None else getattr(feval, "__name__",
                                                     "custom")
        super().__init__("custom(%s)" % name, **kw)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            labels, preds = check_label_shapes(labels, preds, True)
        for label, pred in zip(labels, preds):
            reval = self._feval(_as_np(label), _as_np(pred))
            if isinstance(reval, tuple):
                m, n = reval
                self._add(m, n)
            else:
                self._add(reval, 1)


def np(numpy_feval, name=None, allow_extra_outputs=False):
    """A ``CustomMetric`` from a function of numpy arrays."""
    def feval(label, pred):
        return numpy_feval(label, pred)
    feval.__name__ = getattr(numpy_feval, "__name__", "custom")
    return CustomMetric(feval, name, allow_extra_outputs)


def create(metric, *args, **kwargs):
    """A metric from a name, an instance, a function or a list of them."""
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for m in metric:
            composite.add(create(m, *args, **kwargs))
        return composite
    return _REG.create(metric, *args, **kwargs)
