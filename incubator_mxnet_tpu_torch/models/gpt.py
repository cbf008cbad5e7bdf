"""Decoder-only (GPT-style) causal language model (counterpart of
``incubator_mxnet_tpu/models/gpt.py``): pre-norm blocks, learned positions,
causal flash attention and an LM head tied to the token embedding.
``FeaturesView`` and ``ChunkedLMLoss`` pair the trunk with the chunked
vocabulary cross-entropy for training."""
from __future__ import annotations

import torch

from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..parallel.mesh import P
from .bert import MultiHeadAttention
from .lm_head import ChunkedHeadLossBase

__all__ = ["GPTModel", "TransformerDecoderLayer", "ChunkedLMLoss",
           "FeaturesView"]


class TransformerDecoderLayer(HybridBlock):
    """Pre-norm decoder block: x + attn(ln(x)); x + ffn(ln(x))."""

    def __init__(self, units, hidden_size, num_heads, attention="flash",
                 tp_axis=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.attn = MultiHeadAttention(units, num_heads, attention=attention,
                                       causal=True, sp_axis=sp_axis,
                                       tp_axis=tp_axis)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.fc1 = nn.Dense(hidden_size, flatten=False, in_units=units)
        self.fc2 = nn.Dense(units, flatten=False, in_units=hidden_size)
        if tp_axis:
            self.fc1.weight.sharding = P(tp_axis, None)
            self.fc1.bias.sharding = P(tp_axis)
            self.fc2.weight.sharding = P(None, tp_axis)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        h = nd.LeakyReLU(self.fc1(self.ln2(x)), act_type="gelu")
        return x + self.fc2(h)


class GPTModel(HybridBlock):
    """Decoder-only LM: tokens (B, S) int → logits (B, S, vocab)."""

    def __init__(self, vocab_size=32768, units=768, hidden_size=None,
                 num_layers=12, num_heads=12, max_length=2048,
                 attention="flash", tp_axis=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        hidden_size = hidden_size or 4 * units
        self._max_length = max_length
        self.tok_embed = nn.Embedding(vocab_size, units)
        self.pos_embed = nn.Embedding(max_length, units)
        self.layers = nn.HybridSequential()
        for _ in range(num_layers):
            self.layers.add(TransformerDecoderLayer(
                units, hidden_size, num_heads, attention=attention,
                tp_axis=tp_axis, sp_axis=sp_axis))
        self.ln_f = nn.LayerNorm(in_channels=units)

    def features(self, token_ids):
        """Trunk output (B, S, U), the pre-head activations (an NDArray
        for NDArray ids, as a call of the block gives)."""
        return nd.ndarray._apply(self._features, token_ids)

    def _features(self, token_ids):
        B, S = token_ids.shape
        if S > self._max_length:
            raise ValueError(
                "sequence length %d exceeds max_length %d (position table); "
                "construct GPTModel(max_length=...) large enough" %
                (S, self._max_length))
        pos = torch.arange(S, dtype=torch.int32,
                           device=token_ids.device).reshape(1, S)
        h = self.tok_embed(token_ids) + self.pos_embed(pos)
        h = self.layers(h)
        return self.ln_f(h)

    def forward(self, token_ids):
        h = self.features(token_ids)
        # weight-tied head: logits = h Eᵀ
        e = self.tok_embed.weight._tensor()
        return torch.matmul(h, e.t().to(h.dtype))


class ChunkedLMLoss(ChunkedHeadLossBase):
    """The weight-tied LM head fused with the chunked softmax cross-entropy
    (``ops/lm_ce.py``)::

        gpt = GPTModel(...)
        step = jit.TrainStep(FeaturesView(gpt), ChunkedLMLoss(gpt), trainer)

    The head reads the embedding's own tensor, so its gradient adds to the
    gather's in the one ``tok_embed.weight`` gradient."""

    def _head_params(self):
        return self._model.tok_embed.weight._tensor(), None


class FeaturesView(HybridBlock):
    """A model's ``features`` as its forward, so ``TrainStep``'s
    ``loss_fn(net(*inputs), labels)`` pairs the trunk with a fused loss
    head. The model is the child ``model``: parameter names are
    ``model.<the model's names>``, as in the JAX package."""

    def __init__(self, model, **kwargs):
        super().__init__(**kwargs)
        self.model = model

    def forward(self, *args):
        return self.model.features(*args)
