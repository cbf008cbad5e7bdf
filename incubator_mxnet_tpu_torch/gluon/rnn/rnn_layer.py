"""Fused RNN layers (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``): ``RNN``, ``LSTM`` and
``GRU``, in layouts TNC and NTC, multi-layer and bidirectional, over
``ndarray.rnn_op._rnn`` (the recurrence ``nd.RNN`` runs).

Each layer and direction registers four parameters under MXNet's names,
``{l,r}{layer}_{i2h,h2h}_{weight,bias}``, as attributes, so their
structural names are ``lstm.l0_i2h_weight`` and so on, as in MXNet 1.6
(the JAX package keeps them in lists, out of its structural names). The
i2h weight of the first layer waits for the first forward when
``input_size`` is 0.

Inter-layer ``dropout`` draws its masks once per forward from
``nd.random``'s generator of the device, in training only; the backward
uses the same masks (autograd keeps them).
"""
from __future__ import annotations

import torch

from ... import autograd
from ... import ndarray as nd
from ...ndarray import rnn_op
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RNN", "LSTM", "GRU"]

_GATES = {"rnn": 1, "lstm": 4, "gru": 3}


class _RNNLayer(HybridBlock):
    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, mode, activation=None,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 dtype="float32", **kwargs):
        super().__init__(**kwargs)
        if layout not in ("TNC", "NTC"):
            raise ValueError("layout must be 'TNC' or 'NTC', got %r"
                             % (layout,))
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._mode = mode
        self._op_mode = "rnn_" + activation if mode == "rnn" else mode
        ng = _GATES[mode] * hidden_size
        for layer in range(num_layers):
            in_sz = input_size if layer == 0 else hidden_size * self._dir
            for suffix in "lr"[:self._dir]:
                for name, shape, init in (
                        ("i2h_weight", (ng, in_sz), i2h_weight_initializer),
                        ("h2h_weight", (ng, hidden_size),
                         h2h_weight_initializer),
                        ("i2h_bias", (ng,), i2h_bias_initializer),
                        ("h2h_bias", (ng,), h2h_bias_initializer)):
                    full = "%s%d_%s" % (suffix, layer, name)
                    setattr(self, full, Parameter(
                        full, shape=shape, init=init, dtype=dtype,
                        allow_deferred_init=True))

    def _param(self, kind, layer, d):
        return self._reg_params["%s%d_%s" % ("lr"[d], layer, kind)]

    def state_info(self, batch_size=0):
        """The shape and layout of each state: (h) or (h, c)."""
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (self._num_layers * self._dir, batch_size,
                           self._hidden_size), "__layout__": "LNC"}
                for _ in range(n)]

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """Initial states, ``func(shape, **kwargs)`` each (zeros on the
        current context by default)."""
        return [func(info["shape"], **kwargs)
                for info in self.state_info(batch_size)]

    def _ensure_init(self, in_sz):
        first = self._param("i2h_weight", 0, 0)
        if first._data is not None:
            return
        for d in range(self._dir):
            w = self._param("i2h_weight", 0, d)
            w.shape = (w.shape[0], in_sz)
        for p in self._reg_params.values():
            p._finish_deferred_init()

    def forward(self, inputs, states=None):
        x = inputs if self._layout == "TNC" else inputs.transpose(0, 1)
        self._ensure_init(x.shape[-1])
        skip_states = states is None
        if skip_states:
            states = [x.new_zeros(info["shape"]) for info in
                      self.state_info(x.shape[1])]
        elif isinstance(states, torch.Tensor):
            states = [states]
        weights = {(kind, layer, d): self._param(name, layer, d)._tensor()
                   for layer in range(self._num_layers)
                   for d in range(self._dir)
                   for kind, name in (("wi", "i2h_weight"),
                                      ("wh", "h2h_weight"),
                                      ("bi", "i2h_bias"),
                                      ("bh", "h2h_bias"))}
        lstm = self._mode == "lstm"
        out, h, c = rnn_op._rnn(
            x, states[0], states[1] if lstm else None, weights,
            self._op_mode, self._num_layers, self._dir == 2, self._dropout,
            autograd.is_training())
        if self._layout == "NTC":
            out = out.transpose(0, 1)
        if skip_states:
            return out
        return out, ([h, c] if lstm else [h])

    def __repr__(self):
        return "%s(%d, num_layers=%d)" % (type(self).__name__,
                                          self._hidden_size,
                                          self._num_layers)


class RNN(_RNNLayer):
    """Elman RNN layer, ``activation`` "relu" or "tanh"."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False, input_size=0,
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "rnn", activation,
                         **kwargs)


class LSTM(_RNNLayer):
    """LSTM layer, gates i, f, g, o."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "lstm", **kwargs)


class GRU(_RNNLayer):
    """GRU layer, gates r, z, n."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, "gru", **kwargs)
