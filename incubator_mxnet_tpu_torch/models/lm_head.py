"""Shared chunked LM loss head (counterpart of
``incubator_mxnet_tpu/models/lm_head.py``)."""
from __future__ import annotations

__all__ = ["ChunkedHeadLossBase"]


class ChunkedHeadLossBase:
    """Loss head that fuses a (V, U) vocabulary projection with the chunked
    softmax cross-entropy (``ops/lm_ce.py``), so the full (T, V) logits
    never exist. Subclasses give ``_head_params() -> (weight (V, U), bias
    (V,) or None)``. Pair with ``FeaturesView(model)`` so ``TrainStep``
    feeds it the trunk's activations. Returns the per-sample mean over the
    non-batch axes, the gluon loss contract."""

    def __init__(self, model, chunk=None):
        # chunk=None auto-routes (ops/lm_ce.py): dense up to 128 MiB of fp32
        # logits, 32 MiB chunks above
        self._model = model
        self._chunk = chunk

    def _head_params(self):
        raise NotImplementedError

    def forward(self, hidden, labels):
        from ..ops.lm_ce import chunked_lm_cross_entropy
        w, b = self._head_params()
        losses = chunked_lm_cross_entropy(hidden, w, labels, self._chunk,
                                          head_b=b)
        return losses.reshape(losses.shape[0], -1).mean(dim=1)

    __call__ = forward
