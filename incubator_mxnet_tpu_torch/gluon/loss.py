"""Loss blocks (counterpart of ``incubator_mxnet_tpu/gluon/loss.py``).

Each loss returns one value per sample: the mean over every axis but
``batch_axis``, scaled by ``weight`` and ``sample_weight`` when given (an
NDArray for NDArray arguments, as every block's call). ``jit.TrainStep``
and ``loss.backward()`` seed that vector with ones (the gradient of its
sum), and the trainer's ``rescale_grad / batch_size`` turns the sum into
the batch mean. ``TripletLoss`` and ``CosineEmbeddingLoss`` give their
per-sample values as they are, ``PoissonNLLLoss`` one mean over
everything and ``SDMLLoss`` the batch's KL divergence, as in the JAX
package. ``CTCLoss`` waits for the port of ``ops/ctc.py``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import ndarray as nd
from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "PoissonNLLLoss", "CosineEmbeddingLoss", "SDMLLoss"]


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


class SigmoidBinaryCrossEntropyLoss(Loss):
    """Binary cross-entropy of ``sigmoid(pred)`` (or of ``pred`` itself
    with ``from_sigmoid``) against ``label`` in [0, 1]; ``pos_weight``
    scales the positive term."""

    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = _reshape_like(pred, label)
        if not self._from_sigmoid:
            if pos_weight is None:
                loss = torch.relu(pred) - pred * label + \
                    F.softplus(-pred.abs())
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = pred - pred * label + log_weight * (
                    F.softplus(-pred.abs()) + torch.relu(-pred))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1 - pred + eps) * (1 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1 - pred + eps) * (1 - label))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    """``label * (log(label + 1e-12) - pred)`` with ``pred`` as
    log-probabilities (``from_logits``) or logits."""

    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = nd.log_softmax(pred, axis=self._axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class CTCLoss(Loss):
    """Connectionist temporal classification: waits for the port of
    ``ops/ctc.py``."""

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        raise NotImplementedError("CTCLoss comes with the port of "
                                  "ops/ctc.py")


class HuberLoss(Loss):
    """``|d| - rho / 2`` where ``|d| > rho``, else ``d² / (2 rho)``."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = (_reshape_like(pred, label) - pred).abs()
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * loss.square())
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class HingeLoss(Loss):
    """``max(0, margin - pred * label)`` for labels in {-1, 1}."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * _reshape_like(pred, label))
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class SquaredHingeLoss(Loss):
    """``max(0, margin - pred * label)²``."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin
                          - pred * _reshape_like(pred, label)).square()
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class LogisticLoss(Loss):
    """``log(1 + exp(-pred * label))`` for "signed" labels in {-1, 1}
    (taken to {0, 1} first), or the binary cross-entropy of logits for
    "binary" ones."""

    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = _reshape_like(pred, label)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + F.softplus(-pred.abs())
        return self._per_sample(
            _apply_weighting(loss, self._weight, sample_weight))


class TripletLoss(Loss):
    """``max(0, |pos - pred|² - |neg - pred|² + margin)`` per sample."""

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        positive = _reshape_like(pred, positive)
        negative = _reshape_like(pred, negative)
        loss = ((positive - pred).square() - (negative - pred).square()).sum(
            dim=tuple(range(1, pred.dim())))
        loss = torch.relu(loss + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class PoissonNLLLoss(Loss):
    """Poisson negative log-likelihood of ``target`` with rate
    ``exp(pred)`` (``from_logits``) or ``pred``; ``compute_full`` adds
    Stirling's term where the target exceeds 1. One mean over
    everything."""

    def __init__(self, weight=None, from_logits=True, batch_axis=0,
                 compute_full=False, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._compute_full = compute_full

    def forward(self, pred, target, sample_weight=None, epsilon=1e-08):
        target = _reshape_like(pred, target)
        if self._from_logits:
            loss = torch.exp(pred) - target * pred
        else:
            loss = pred - target * torch.log(pred + epsilon)
        if self._compute_full:
            stirling = target * torch.log(target + 1e-12) - target \
                + 0.5 * torch.log(2 * math.pi * (target + 1e-12))
            loss = loss + stirling * (target > 1)
        return _apply_weighting(loss, self._weight, sample_weight).mean()


class CosineEmbeddingLoss(Loss):
    """``1 - cos(input1, input2)`` for label 1, ``max(0, cos - margin)``
    otherwise, per sample. ``input1`` takes ``input2``'s shape, as in MXNet
    (the JAX package's ``_reshape_like`` returns ``input2`` itself, so it
    takes the cosine of ``input2`` with itself)."""

    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        if input1.shape != input2.shape:
            input1 = input1.reshape(input2.shape)
        cos_sim = (input1 * input2).sum(dim=-1) / (
            input1.norm(dim=-1) * input2.norm(dim=-1) + 1e-12)
        label = label.reshape(-1)
        loss = torch.where(label == 1, 1.0 - cos_sim,
                           torch.relu(cos_sim - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)


class SDMLLoss(Loss):
    """Batchwise smoothed deep metric learning (Bonadiman et al., 2019):
    rows of ``x1`` and ``x2`` are aligned pairs, the other rows in-batch
    negatives; the KL divergence between ``softmax(-distances)`` and the
    smoothed identity, times the batch size."""

    def __init__(self, smoothing_parameter=0.3, weight=1.0, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.kl_loss = KLDivLoss(from_logits=True)
        self.smoothing_parameter = smoothing_parameter

    def forward(self, x1, x2):
        n = x1.shape[0]
        distances = (x1.unsqueeze(1) - x2.unsqueeze(0)).square().sum(dim=2)
        gold = torch.eye(n, dtype=x1.dtype, device=x1.device)
        s = self.smoothing_parameter
        labels = gold * (1 - s) + (1.0 - gold) * (s / (n - 1))
        log_probabilities = nd.log_softmax(-distances, axis=1)
        return self.kl_loss(log_probabilities, labels) * n
