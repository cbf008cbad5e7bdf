"""Chunked LM cross-entropy (counterpart of
``incubator_mxnet_tpu/ops/lm_ce.py``).

``chunked_lm_cross_entropy(hidden, head_w, labels, chunk)`` computes the
per-token cross-entropy of a (V, U) vocabulary head without holding the
full (T, V) logits: token chunks are projected one at a time, each to an
fp32 log-sum-exp minus the label's logit. The backward recomputes each
chunk's logits from its (chunk, U) input (``torch.utils.checkpoint``), so
no (n, chunk, V) stack of softmax residuals stays alive either. One chunk
is the dense path, with nothing recomputed.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

__all__ = ["chunked_lm_cross_entropy"]

# Auto-route thresholds, in bytes of the fp32 (T, V) logits block: up to
# _DENSE_BYTES one chunk (the dense path); above, chunks of about
# _BLOCK_BYTES of logits each.
_DENSE_BYTES = 128 * 1024 * 1024
_BLOCK_BYTES = 32 * 1024 * 1024


def _chunk_ce(h, w, y, b=None):
    """Per-token ``lse(logits) - logits[y]`` of one chunk, in fp32."""
    logits = torch.matmul(h, w.t().to(h.dtype)).float()
    if b is not None:
        logits = logits + b.float()
    m = logits.amax(dim=-1, keepdim=True)
    lse = (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True)))
    lab = torch.gather(logits, 1, y.unsqueeze(1))
    return (lse - lab)[:, 0]


def chunked_lm_cross_entropy(hidden, head_w, labels, chunk=None,
                             head_b=None):
    """hidden: (..., U); head_w: (V, U) (tied embedding or untied head);
    head_b: optional (V,) bias; labels: (...,) int. Returns fp32 per-token
    losses shaped like labels.

    ``chunk=None`` auto-routes: one chunk when the fp32 (T, V) logits fit
    in 128 MiB, else chunks of about 32 MiB of logits. A T that the chunk
    does not divide is zero-padded to the next multiple and the pad's
    losses dropped."""
    shape = labels.shape
    U = hidden.shape[-1]
    h = hidden.reshape(-1, U)
    y = labels.reshape(-1).long()
    T, V = h.shape[0], head_w.shape[0]
    if chunk is None:
        chunk = T if T * V * 4 <= _DENSE_BYTES else \
            max(1, _BLOCK_BYTES // (V * 4))
    chunk = min(chunk, T)
    pad = (-T) % chunk
    if pad:
        h = torch.cat([h, h.new_zeros(pad, U)])
        y = torch.cat([y, y.new_zeros(pad)])
    if h.shape[0] == chunk:
        losses = _chunk_ce(h, head_w, y, head_b)
    else:
        losses = torch.cat([
            checkpoint(_chunk_ce, hc, head_w, yc, head_b, use_reentrant=False)
            for hc, yc in zip(h.split(chunk), y.split(chunk))])
    return losses[:T].reshape(shape)
