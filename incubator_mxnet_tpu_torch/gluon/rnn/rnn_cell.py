"""Recurrent cells (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``): one step a call,
``cell(inputs, states) -> (output, new_states)``, and ``unroll`` for a
whole sequence, a Python loop over its steps.

The gate orders are MXNet's (LSTM i, f, g, o; GRU r, z, n), each cell
with an i2h and an h2h weight and bias registered as attributes
(``i2h_weight`` …). A modifier (``DropoutCell``'s inputs,
``ZoneoutCell``, ``ResidualCell``) wraps its ``base_cell``; the stacked
and bidirectional cells hold theirs as children "0", "1", … and
``l_cell``/``r_cell``.

``unroll(length, inputs, begin_state, layout, merge_outputs,
valid_length)`` takes the sequence as one array (``layout`` "NTC" or
"TNC") or a list of (N, C) steps. With ``valid_length`` (N,) the outputs
at or past a sequence's length are zeros and merged, and the states
returned are each sequence's at its last valid step, as MXNet's
``unroll`` returns them.
"""
from __future__ import annotations

import torch

from ... import ndarray as nd
from ...context import context_of
from ...ndarray import NDArray
from ..block import HybridBlock
from ..parameter import Parameter

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "HybridSequentialRNNCell",
           "ModifierCell", "DropoutCell", "ZoneoutCell", "ResidualCell",
           "BidirectionalCell"]


def _steps(inputs, length, layout):
    """(the list of (N, C) steps, the batch size) of ``inputs``."""
    if isinstance(inputs, (list, tuple)):
        return list(inputs), inputs[0].shape[0]
    axis = layout.find("T")
    batch = inputs.shape[1 - axis if axis in (0, 1) else 0]
    if length == 1:
        return [inputs.squeeze(axis)], batch
    return list(nd.split(inputs, length, axis=axis, squeeze_axis=True)), batch


def _context(x):
    return x.context if isinstance(x, NDArray) else context_of(x)


class RecurrentCell(HybridBlock):
    """Base cell: ``state_info``, ``begin_state``, ``unroll``; a call is
    one step."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset the step counters, here and in every child cell."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._modules.values():
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        """``func(shape, **kwargs)`` for each state (zeros on the current
        context by default)."""
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            info = dict(info, **kwargs)
            shape = info.pop("shape")
            info.pop("__layout__", None)
            states.append(func(shape, **info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Run ``length`` steps; (outputs, states). Outputs are a list of
        steps, or stacked along ``layout``'s T axis with ``merge_outputs``
        or ``valid_length``."""
        self.reset()
        axis = layout.find("T")
        seq, batch = _steps(inputs, length, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=_context(seq[0]))
        outputs, all_states = [], []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
            all_states.append(states)
        if valid_length is not None:
            states = [nd.SequenceLast(nd.stack(*steps, axis=0), valid_length,
                                      use_sequence_length=True, axis=0)
                      for steps in zip(*all_states)]
            outputs = nd.SequenceMask(nd.stack(*outputs, axis=axis),
                                      valid_length, use_sequence_length=True,
                                      axis=axis)
        elif merge_outputs:
            outputs = nd.stack(*outputs, axis=axis)
        return outputs, states

    def __call__(self, inputs, states):
        self._counter += 1
        return super().__call__(inputs, states)


class _GatedCell(RecurrentCell):
    """A cell of ``gates`` gates over an i2h and an h2h product."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, **kwargs):
        super().__init__(**kwargs)
        self._hidden_size = hidden_size
        self._input_size = input_size
        ng = self._gates * hidden_size
        self.i2h_weight = Parameter("i2h_weight", shape=(ng, input_size),
                                    init=i2h_weight_initializer,
                                    allow_deferred_init=True)
        self.h2h_weight = Parameter("h2h_weight", shape=(ng, hidden_size),
                                    init=h2h_weight_initializer,
                                    allow_deferred_init=True)
        self.i2h_bias = Parameter("i2h_bias", shape=(ng,),
                                  init=i2h_bias_initializer,
                                  allow_deferred_init=True)
        self.h2h_bias = Parameter("h2h_bias", shape=(ng,),
                                  init=h2h_bias_initializer,
                                  allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _products(self, inputs, h):
        """(x·Wiᵀ + bi, h·Whᵀ + bh), initializing deferred weights."""
        if self.i2h_weight._data is None:
            self.i2h_weight.shape = (self.i2h_weight.shape[0],
                                     inputs.shape[-1])
            for p in (self.i2h_weight, self.h2h_weight, self.i2h_bias,
                      self.h2h_bias):
                p._finish_deferred_init()
        return (torch.nn.functional.linear(inputs, self.i2h_weight._tensor(),
                                           self.i2h_bias._tensor()),
                torch.nn.functional.linear(h, self.h2h_weight._tensor(),
                                           self.h2h_bias._tensor()))


class RNNCell(_GatedCell):
    """Elman cell: h' = act(x·Wiᵀ + bi + h·Whᵀ + bh)."""

    def __init__(self, hidden_size, activation="tanh", **kwargs):
        super().__init__(hidden_size, **kwargs)
        self._activation = activation

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        output = nd.Activation(i2h + h2h, act_type=self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM cell, gates i, f, g, o; states (h, c)."""

    _gates = 4

    def state_info(self, batch_size=0):
        return super().state_info(batch_size) * 2

    def forward(self, inputs, states):
        i2h, h2h = self._products(inputs, states[0])
        i, f, g, o = (i2h + h2h).chunk(4, dim=-1)
        next_c = torch.sigmoid(f) * states[1] \
            + torch.sigmoid(i) * torch.tanh(g)
        next_h = torch.sigmoid(o) * torch.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU cell, gates r, z, n: n = tanh(x·Wnᵀ + bn + r ⊙ (h·Wnᵀ + bn))."""

    _gates = 3

    def forward(self, inputs, states):
        prev_h = states[0]
        i2h, h2h = self._products(inputs, prev_h)
        i2h_r, i2h_z, i2h_n = i2h.chunk(3, dim=-1)
        h2h_r, h2h_z, h2h_n = h2h.chunk(3, dim=-1)
        reset_gate = torch.sigmoid(i2h_r + h2h_r)
        update_gate = torch.sigmoid(i2h_z + h2h_z)
        next_h_tmp = torch.tanh(i2h_n + reset_gate * h2h_n)
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Cells stacked: each step runs them in order, each on its own
    states."""

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return [info for cell in self._modules.values()
                for info in cell.state_info(batch_size)]

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        return [s for cell in self._modules.values()
                for s in cell.begin_state(batch_size, func, **kwargs)]

    def forward(self, inputs, states):
        next_states, p = [], 0
        for cell in self._modules.values():
            n = len(cell.state_info())
            inputs, s = cell(inputs, states[p:p + n])
            next_states.extend(s)
            p += n
        return inputs, next_states

    def __len__(self):
        return len(self._modules)

    def __getitem__(self, i):
        return list(self._modules.values())[i]


class ModifierCell(RecurrentCell):
    """A cell that changes what its ``base_cell`` does; their states are
    the base cell's."""

    def __init__(self, base_cell):
        super().__init__()
        self.base_cell = base_cell

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        return self.base_cell.begin_state(batch_size, func, **kwargs)


class DropoutCell(RecurrentCell):
    """Dropout on the inputs of a step (no states)."""

    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def forward(self, inputs, states):
        if self._rate > 0:
            inputs = nd.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ZoneoutCell(ModifierCell):
    """Zoneout: in training, each output and state entry keeps its previous
    value with probability ``zoneout_outputs`` / ``zoneout_states``."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def forward(self, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0.0:
            mask = nd.Dropout(torch.ones_like(next_output),
                              p=self.zoneout_outputs)
            prev = self._prev_output if self._prev_output is not None \
                else torch.zeros_like(next_output)
            next_output = torch.where(mask != 0, next_output, prev)
        if self.zoneout_states > 0.0:
            next_states = [
                torch.where(nd.Dropout(torch.ones_like(ns),
                                       p=self.zoneout_states) != 0, ns, s)
                for ns, s in zip(next_states, states)]
        self._prev_output = next_output
        return next_output, next_states


class ResidualCell(ModifierCell):
    """The base cell's output plus the step's input."""

    def forward(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(RecurrentCell):
    """``l_cell`` over the sequence and ``r_cell`` over it reversed (each
    sequence within its ``valid_length``), outputs concatenated on the
    last axis; ``unroll`` only."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__()
        self.register_child(l_cell, "l_cell")
        self.register_child(r_cell, "r_cell")

    def state_info(self, batch_size=0):
        return (self.l_cell.state_info(batch_size)
                + self.r_cell.state_info(batch_size))

    def begin_state(self, batch_size=0, func=nd.zeros, **kwargs):
        return (self.l_cell.begin_state(batch_size, func, **kwargs)
                + self.r_cell.begin_state(batch_size, func, **kwargs))

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell supports only unroll()")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            inputs = nd.stack(*inputs, axis=axis)
        seq, batch = _steps(inputs, length, layout)
        states = begin_state if begin_state is not None else \
            self.begin_state(batch, ctx=_context(seq[0]))
        n_l = len(self.l_cell.state_info())
        l_out, l_states = self.l_cell.unroll(length, inputs, states[:n_l],
                                             layout, True, valid_length)
        r_out, r_states = self.r_cell.unroll(
            length, self._reverse(inputs, axis, valid_length), states[n_l:],
            layout, True, valid_length)
        outputs = nd.concat(l_out, self._reverse(r_out, axis, valid_length),
                            dim=2)
        return outputs, l_states + r_states

    @staticmethod
    def _reverse(x, axis, valid_length):
        """Each sequence of ``x`` reversed along ``axis`` within its
        length."""
        if axis != 0:
            x = nd.swapaxes(x, 0, axis)
        x = nd.SequenceReverse(x, valid_length, valid_length is not None,
                               axis=0)
        return nd.swapaxes(x, 0, axis) if axis != 0 else x


# Every cell here can be hybridized, so MXNet's Hybrid names are the same
# classes.
HybridRecurrentCell = RecurrentCell
HybridSequentialRNNCell = SequentialRNNCell
