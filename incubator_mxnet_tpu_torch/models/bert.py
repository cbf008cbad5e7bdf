"""BERT / Transformer encoder (counterpart of
``incubator_mxnet_tpu/models/bert.py``).

Child names equal the JAX package's, so ``state_dict()`` keys are its
structural parameter names. ``attention="flash"`` runs the CUDA
flash-attention kernels (ops/attention.py: the forward, and the two
backward kernels when training); ``"dense"`` the composite; ``"ring"`` and
``"ulysses"`` the sequence-parallel attentions of ``parallel`` over the
``sp_axis`` of ``parallel.current_mesh()`` (their local steps are the same
kernels). ``tp_axis`` splits the heads and the FFN hidden over a mesh axis,
as the JAX package annotates them: q, k, v and ffn1 column parallel, proj
and ffn2 row parallel (``parallel.tensor_parallel``).
"""
from __future__ import annotations

import math

import torch

from .. import ndarray as nd
from ..gluon import nn
from ..gluon.block import HybridBlock
from ..gluon.parameter import Parameter
from ..parallel.mesh import P
from .lm_head import ChunkedHeadLossBase

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "BERTEncoder",
           "BERTModel", "ChunkedMLMLoss"]


class MultiHeadAttention(HybridBlock):
    def __init__(self, units, num_heads, dropout=0.0, attention="dense",
                 sp_axis="sp", tp_axis=None, causal=False, **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units %d not divisible by num_heads %d"
                             % (units, num_heads))
        if attention not in ("dense", "flash", "ring", "ulysses"):
            raise ValueError("unknown attention %r" % attention)
        self._num_heads = num_heads
        self._dropout = dropout
        self._attention = attention
        self._sp_axis = sp_axis
        self._causal = causal
        self.query = nn.Dense(units, flatten=False, in_units=units)
        self.key = nn.Dense(units, flatten=False, in_units=units)
        self.value = nn.Dense(units, flatten=False, in_units=units)
        self.proj = nn.Dense(units, flatten=False, in_units=units)
        if tp_axis:
            # heads split over tp: q, k, v column parallel, proj row parallel
            for lyr in (self.query, self.key, self.value):
                lyr.weight.sharding = P(tp_axis, None)
                lyr.bias.sharding = P(tp_axis)
            self.proj.weight.sharding = P(None, tp_axis)

    def forward(self, x, mask=None):
        B, S, U = x.shape
        H = self._num_heads
        D = U // H
        q = self.query(x).reshape(B, S, H, D).transpose(1, 2)
        k = self.key(x).reshape(B, S, H, D).transpose(1, 2)
        v = self.value(x).reshape(B, S, H, D).transpose(1, 2)
        causal = self._causal
        if self._attention in ("ring", "ulysses"):
            from ..parallel import mesh as _mesh
            from ..parallel.ring_attention import ring_attention
            from ..parallel.ulysses import ulysses_attention
            fn = ring_attention if self._attention == "ring" \
                else ulysses_attention
            out = fn(q.contiguous(), k.contiguous(), v.contiguous(),
                     mesh=_mesh.current_mesh(), axis=self._sp_axis,
                     causal=causal)
        elif self._attention == "flash":
            from ..ops.attention import flash_attention
            # the kernel reads (B, H, S, D) rows densely
            out = flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous(), causal)
        else:
            scale = 1.0 / math.sqrt(D)
            scores = nd.batch_dot(q.reshape(B * H, S, D),
                                  k.reshape(B * H, S, D),
                                  transpose_b=True) * scale
            if causal:
                keep = torch.ones(S, S, dtype=torch.bool,
                                  device=x.device).tril()
                scores = torch.where(keep, scores,
                                     torch.full_like(scores, -1e9))
            if mask is not None:
                scores = scores.reshape(B, H, S, S) + (1.0 - mask) * -1e9
                scores = scores.reshape(B * H, S, S)
            attn = nd.softmax(scores, axis=-1)
            if self._dropout:
                attn = nd.Dropout(attn, p=self._dropout)
            out = nd.batch_dot(attn, v.reshape(B * H, S, D)) \
                .reshape(B, H, S, D)
        out = out.transpose(1, 2).reshape(B, S, U)
        return self.proj(out)


class TransformerEncoderLayer(HybridBlock):
    def __init__(self, units, hidden_size, num_heads, dropout=0.1,
                 attention="dense", tp_axis=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        self.attention_cell = MultiHeadAttention(units, num_heads, dropout,
                                                 attention, sp_axis, tp_axis)
        self.ln1 = nn.LayerNorm(in_channels=units)
        self.ffn1 = nn.Dense(hidden_size, flatten=False, in_units=units)
        self.ffn2 = nn.Dense(units, flatten=False, in_units=hidden_size)
        self.ln2 = nn.LayerNorm(in_channels=units)
        self.dropout_layer = nn.Dropout(dropout) if dropout else None
        if tp_axis:
            self.ffn1.weight.sharding = P(tp_axis, None)
            self.ffn1.bias.sharding = P(tp_axis)
            self.ffn2.weight.sharding = P(None, tp_axis)

    def forward(self, x, mask=None):
        h = self.attention_cell(x, mask)
        if self.dropout_layer is not None:
            h = self.dropout_layer(h)
        x = self.ln1(x + h)
        h = self.ffn2(nd.LeakyReLU(self.ffn1(x), act_type="gelu"))
        if self.dropout_layer is not None:
            h = self.dropout_layer(h)
        return self.ln2(x + h)


class BERTEncoder(HybridBlock):
    def __init__(self, units=768, hidden_size=3072, num_layers=12,
                 num_heads=12, max_length=512, dropout=0.1,
                 attention="dense", tp_axis=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        self.position_weight = Parameter("position_weight",
                                         shape=(max_length, units),
                                         init="normal")
        self.layers = []
        for i in range(num_layers):
            layer = TransformerEncoderLayer(units, hidden_size, num_heads,
                                            dropout, attention, tp_axis,
                                            sp_axis)
            self.register_child(layer, "layer%d" % i)
            self.layers.append(layer)

    def forward(self, x, mask=None):
        S = x.shape[1]
        pos = nd.slice_axis(self.position_weight._tensor(), 0, 0, S)
        x = x + pos.unsqueeze(0)
        for layer in self.layers:
            x = layer(x, mask)
        return x


class BERTModel(HybridBlock):
    """BERT with embeddings + MLM head: tokens (B, S) → logits (B, S, V)."""

    def __init__(self, vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512, dropout=0.1,
                 attention="dense", tp_axis=None, sp_axis="sp", **kwargs):
        super().__init__(**kwargs)
        self.word_embed = nn.Embedding(vocab_size, units)
        self.token_type_embed = nn.Embedding(2, units)
        self.embed_ln = nn.LayerNorm(in_channels=units)
        self.embed_dropout = nn.Dropout(dropout) if dropout else None
        self.encoder = BERTEncoder(units, hidden_size, num_layers, num_heads,
                                   max_length, dropout, attention, tp_axis,
                                   sp_axis)
        self.mlm_dense = nn.Dense(units, flatten=False, activation="relu",
                                  in_units=units)
        self.mlm_ln = nn.LayerNorm(in_channels=units)
        self.mlm_decoder = nn.Dense(vocab_size, flatten=False, in_units=units)

    def forward(self, token_ids, token_types=None, mask=None):
        return self.mlm_decoder(self.features(token_ids, token_types, mask))

    def features(self, token_ids, token_types=None, mask=None):
        """Pre-decoder MLM activations (B, S, U)."""
        x = self.word_embed(token_ids)
        if token_types is not None:
            x = x + self.token_type_embed(token_types)
        x = self.embed_ln(x)
        if self.embed_dropout is not None:
            x = self.embed_dropout(x)
        h = self.encoder(x, mask)
        return self.mlm_ln(self.mlm_dense(h))


class ChunkedMLMLoss(ChunkedHeadLossBase):
    """BERT's counterpart of ``gpt.ChunkedLMLoss``: the untied, biased
    ``mlm_decoder`` fused with the chunked softmax cross-entropy. Use with
    ``FeaturesView(bert)``."""

    def _head_params(self):
        return (self._model.mlm_decoder.weight._tensor(),
                self._model.mlm_decoder.bias._tensor())
