"""Loss blocks (counterpart of ``incubator_mxnet_tpu/gluon/loss.py``).

Each loss returns one value per sample: the mean over every axis but
``batch_axis``, scaled by ``weight`` and ``sample_weight`` when given (an
NDArray for NDArray arguments, as every block's call). ``jit.TrainStep``
and ``loss.backward()`` seed that vector with ones (the gradient of its
sum), and the trainer's ``rescale_grad / batch_size`` turns the sum into
the batch mean.
"""
from __future__ import annotations

from .. import ndarray as nd
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _reshape_like(pred, label):
    return label.reshape(pred.shape) if label.shape != pred.shape else label


class Loss(HybridBlock):
    """Base loss: ``weight`` scales it, ``batch_axis`` is kept."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _per_sample(self, loss):
        axes = tuple(i for i in range(loss.ndim) if i != self._batch_axis)
        return loss.mean(dim=axes) if axes else loss

    def __repr__(self):
        return "%s(batch_axis=%s, w=%s)" % (
            type(self).__name__, self._batch_axis, self._weight)


class L2Loss(Loss):
    """``weight / 2 * (label - pred)²``."""

    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred) ** 2
        return self._per_sample(
            _apply_weighting(loss, self._weight / 2, sample_weight))


class L1Loss(Loss):
    """``|label - pred|``."""

    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred).abs()
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SoftmaxCrossEntropyLoss(Loss):
    """``-log softmax(pred)[label]`` along ``axis`` (``sparse_label``), or
    ``-sum(label * log softmax(pred))`` for dense labels; ``from_logits``
    takes ``pred`` as log-probabilities already."""

    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = nd.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            loss = -nd.pick(pred, label, axis=self._axis, keepdims=False)
        else:
            label = _reshape_like(pred, label)
            loss = -(pred * label).sum(dim=self._axis)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


SoftmaxCELoss = SoftmaxCrossEntropyLoss
