"""gluon.contrib.rnn (counterpart of
``incubator_mxnet_tpu/gluon/contrib/rnn.py``; MXNet's
``gluon/contrib/rnn/{conv_rnn_cell,rnn_cell}.py``).

- ``Conv{1,2,3}D{RNN,LSTM,GRU}Cell``: the dense cells' gate arithmetic
  over convolutions (i2h over the input, h2h over the state, whose odd
  kernel keeps its spatial shape). ``input_shape`` is (C, *spatial)
  without the batch, so the state's shape is known before any input.
- ``VariationalDropoutCell``: one dropout mask per sequence, drawn at the
  first step (inputs, states, outputs each their own) and reused at every
  step until ``reset`` (Gal & Ghahramani).
- ``LSTMPCell``: an LSTM whose hidden state is projected (states [r, c],
  Sak et al. 2014).
"""
from __future__ import annotations

from ... import autograd
from ... import ndarray as nd
from ..parameter import Parameter
from ..rnn.rnn_cell import (LSTMCell, ModifierCell,  # noqa: F401
                            RecurrentCell, _context)

__all__ = ["Conv1DRNNCell", "Conv2DRNNCell", "Conv3DRNNCell",
           "Conv1DLSTMCell", "Conv2DLSTMCell", "Conv3DLSTMCell",
           "Conv1DGRUCell", "Conv2DGRUCell", "Conv3DGRUCell",
           "VariationalDropoutCell", "LSTMPCell"]


def _tup(v, n):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


class _ConvRNNCellBase(RecurrentCell):
    """What the conv cells share: i2h (g·H, C, *k) and h2h (g·H, H, *k)
    weights and their biases (zeros), g the cell's gate count."""

    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 dims=2, num_gates=1, **kwargs):
        super().__init__(**kwargs)
        self._dims = dims
        self._input_shape = tuple(input_shape)
        self._hc = hidden_channels
        self._activation = activation
        self._num_gates = num_gates
        self._i2h_kernel = _tup(i2h_kernel, dims)
        self._h2h_kernel = _tup(h2h_kernel, dims)
        if any(k % 2 != 1 for k in self._h2h_kernel):
            raise ValueError(
                "h2h_kernel must be odd so the state keeps its spatial "
                "shape; got %s" % (self._h2h_kernel,))
        self._i2h_pad = _tup(i2h_pad, dims)
        self._i2h_dilate = _tup(i2h_dilate, dims)
        self._h2h_dilate = _tup(h2h_dilate, dims)
        self._h2h_pad = tuple(d * (k - 1) // 2 for d, k in
                              zip(self._h2h_dilate, self._h2h_kernel))
        in_c, spatial = self._input_shape[0], self._input_shape[1:]
        self._state_spatial = tuple(
            s + 2 * p - d * (k - 1) for s, p, d, k in zip(
                spatial, self._i2h_pad, self._i2h_dilate, self._i2h_kernel))
        ng = num_gates * hidden_channels
        self.i2h_weight = Parameter("i2h_weight",
                                    shape=(ng, in_c) + self._i2h_kernel)
        self.h2h_weight = Parameter(
            "h2h_weight", shape=(ng, hidden_channels) + self._h2h_kernel)
        self.i2h_bias = Parameter("i2h_bias", shape=(ng,), init="zeros")
        self.h2h_bias = Parameter("h2h_bias", shape=(ng,), init="zeros")

    def state_info(self, batch_size=0):
        shape = (batch_size, self._hc) + self._state_spatial
        n = 2 if isinstance(self, _ConvLSTMMixin) else 1
        return [{"shape": shape, "__layout__": "NC" + "DHW"[3 - self._dims:]}
                for _ in range(n)]

    def _conv_gates(self, inputs, state):
        ones = (1,) * self._dims
        i2h = nd.Convolution(inputs, self.i2h_weight._tensor(),
                             self.i2h_bias._tensor(), kernel=self._i2h_kernel,
                             stride=ones, dilate=self._i2h_dilate,
                             pad=self._i2h_pad,
                             num_filter=self._num_gates * self._hc)
        h2h = nd.Convolution(state, self.h2h_weight._tensor(),
                             self.h2h_bias._tensor(), kernel=self._h2h_kernel,
                             stride=ones, dilate=self._h2h_dilate,
                             pad=self._h2h_pad,
                             num_filter=self._num_gates * self._hc)
        return i2h, h2h


class _ConvRNNMixin:
    def _alias(self):
        return "conv_rnn"

    def forward(self, inputs, states):
        i2h, h2h = self._conv_gates(inputs, states[0])
        out = nd.Activation(i2h + h2h, act_type=self._activation)
        return out, [out]


class _ConvLSTMMixin:
    def _alias(self):
        return "conv_lstm"

    def forward(self, inputs, states):
        i2h, h2h = self._conv_gates(inputs, states[0])
        i, f, g, o = nd.split(i2h + h2h, 4, axis=1)
        next_c = nd.sigmoid(f) * states[1] + \
            nd.sigmoid(i) * nd.Activation(g, act_type=self._activation)
        next_h = nd.sigmoid(o) * nd.Activation(next_c,
                                               act_type=self._activation)
        return next_h, [next_h, next_c]


class _ConvGRUMixin:
    def _alias(self):
        return "conv_gru"

    def forward(self, inputs, states):
        i2h, h2h = self._conv_gates(inputs, states[0])
        i_r, i_z, i_n = nd.split(i2h, 3, axis=1)
        h_r, h_z, h_n = nd.split(h2h, 3, axis=1)
        reset = nd.sigmoid(i_r + h_r)
        update = nd.sigmoid(i_z + h_z)
        newmem = nd.Activation(i_n + reset * h_n, act_type=self._activation)
        out = (1.0 - update) * newmem + update * states[0]
        return out, [out]


def _make_cell(name, mixin, dims, gates):
    def __init__(self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
                 i2h_pad=0, i2h_dilate=1, h2h_dilate=1, activation="tanh",
                 **kwargs):
        _ConvRNNCellBase.__init__(
            self, input_shape, hidden_channels, i2h_kernel, h2h_kernel,
            i2h_pad=i2h_pad, i2h_dilate=i2h_dilate, h2h_dilate=h2h_dilate,
            activation=activation, dims=dims, num_gates=gates, **kwargs)
    return type(name, (mixin, _ConvRNNCellBase), {
        "__init__": __init__, "__module__": __name__,
        "__doc__": "%s: a %d-gate recurrence over %d-D feature maps."
                   % (name, gates, dims)})


Conv1DRNNCell = _make_cell("Conv1DRNNCell", _ConvRNNMixin, 1, 1)
Conv2DRNNCell = _make_cell("Conv2DRNNCell", _ConvRNNMixin, 2, 1)
Conv3DRNNCell = _make_cell("Conv3DRNNCell", _ConvRNNMixin, 3, 1)
Conv1DLSTMCell = _make_cell("Conv1DLSTMCell", _ConvLSTMMixin, 1, 4)
Conv2DLSTMCell = _make_cell("Conv2DLSTMCell", _ConvLSTMMixin, 2, 4)
Conv3DLSTMCell = _make_cell("Conv3DLSTMCell", _ConvLSTMMixin, 3, 4)
Conv1DGRUCell = _make_cell("Conv1DGRUCell", _ConvGRUMixin, 1, 3)
Conv2DGRUCell = _make_cell("Conv2DGRUCell", _ConvGRUMixin, 2, 3)
Conv3DGRUCell = _make_cell("Conv3DGRUCell", _ConvGRUMixin, 3, 3)


class VariationalDropoutCell(ModifierCell):
    """Dropout with one mask a sequence for the inputs, the first state and
    the outputs (rates ``drop_inputs``, ``drop_states``, ``drop_outputs``),
    in training only. Each mask is drawn from ``nd.random`` at its first
    use after ``reset`` (``unroll`` resets) and kept in ``_mask_in`` /
    ``_mask_state`` / ``_mask_out``."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self._drop_inputs = drop_inputs
        self._drop_states = drop_states
        self._drop_outputs = drop_outputs
        self.reset()

    def reset(self):
        super().reset()
        self._mask_in = None
        self._mask_state = None
        self._mask_out = None

    def _mask(self, cache_name, x, rate):
        mask = getattr(self, cache_name)
        if mask is None:
            keep = 1.0 - rate
            draw = nd.random.uniform(shape=x.shape, ctx=_context(x))
            mask = (draw < keep).astype(x.dtype) / keep
            setattr(self, cache_name, mask)
        return x * mask

    def forward(self, inputs, states):
        if autograd.is_training():
            if self._drop_inputs:
                inputs = self._mask("_mask_in", inputs, self._drop_inputs)
            if self._drop_states:
                states = [self._mask("_mask_state", states[0],
                                     self._drop_states)] + list(states[1:])
        out, nstates = self.base_cell(inputs, states)
        if autograd.is_training() and self._drop_outputs:
            out = self._mask("_mask_out", out, self._drop_outputs)
        return out, nstates


class LSTMPCell(RecurrentCell):
    """LSTM with a projection: gates from x and the projected state r
    (i2h (4H, C), h2h (4H, P)), c' = σ(f)·c + σ(i)·tanh(g),
    h = σ(o)·tanh(c'), r' = h·h2rᵀ (P, H). States [r, c]."""

    def __init__(self, hidden_size, projection_size, input_size=0, **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self.i2h_weight = Parameter("i2h_weight",
                                    shape=(4 * hidden_size, input_size),
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter("h2h_weight",
                                    shape=(4 * hidden_size, projection_size),
                                    allow_deferred_init=True)
        self.h2r_weight = Parameter("h2r_weight",
                                    shape=(projection_size, hidden_size),
                                    allow_deferred_init=True)
        self.i2h_bias = Parameter("i2h_bias", shape=(4 * hidden_size,),
                                  init="zeros", allow_deferred_init=True)
        self.h2h_bias = Parameter("h2h_bias", shape=(4 * hidden_size,),
                                  init="zeros", allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def forward(self, inputs, states):
        if self.i2h_weight._data is None:
            self.i2h_weight.shape = (4 * self._hidden_size, inputs.shape[-1])
            for p in (self.i2h_weight, self.h2h_weight, self.h2r_weight,
                      self.i2h_bias, self.h2h_bias):
                p._finish_deferred_init()
        n = 4 * self._hidden_size
        i2h = nd.FullyConnected(inputs, self.i2h_weight._tensor(),
                                self.i2h_bias._tensor(), num_hidden=n,
                                flatten=False)
        h2h = nd.FullyConnected(states[0], self.h2h_weight._tensor(),
                                self.h2h_bias._tensor(), num_hidden=n,
                                flatten=False)
        i, f, g, o = nd.split(i2h + h2h, 4, axis=-1)
        next_c = nd.sigmoid(f) * states[1] + nd.sigmoid(i) * nd.tanh(g)
        next_h = nd.sigmoid(o) * nd.tanh(next_c)
        next_r = nd.FullyConnected(next_h, self.h2r_weight._tensor(), None,
                                   num_hidden=self._projection_size,
                                   no_bias=True, flatten=False)
        return next_r, [next_r, next_c]
