"""The legacy symbolic RNN cells (counterpart of
``incubator_mxnet_tpu/rnn/rnn_cell.py``; MXNet's ``python/mxnet/rnn/
rnn_cell.py``): cells that build ``Symbol`` graphs for ``Module`` and
``BucketingModule``.

Each unrolled step is plain symbol composition over the port's ``nd``
operators, and the bound ``Executor`` runs the unrolled graph eagerly, one
operator at a time. The parameter names (``<prefix>i2h_weight``, ...) and
the graph JSON are the JAX package's, so ``.params`` files and ``tojson()``
cross between the packages. ``FusedRNNCell`` is, as there, the stacked
(optionally bidirectional) composition with the fused cell's prefixes, and
``unfuse()`` gives the explicit stack.

The zero begin state of ``begin_state(like=x)`` is the ``_begin_state``
operator: ``(batch of x, num_hidden)`` zeros on ``x``'s device and in its
dtype, made at bind and at every forward (on meta tensors during shape
inference). It is registered in ``symbol._OP_TABLE`` at import, so the
JSON of an unrolled graph reloads.
"""
from __future__ import annotations

import torch

from .. import symbol as sym
from ..ndarray import NDArray
from ..symbol.symbol import Symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """The cells' weights by name: one namespace, so stacked and
    bidirectional cells share variables by name."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = sym.var(name, **kwargs)
        return self._params[name]


def _begin_state_op(d, num_hidden=0):
    """(batch of ``d``, ``num_hidden``) zeros on ``d``'s device (meta
    tensors included) and in its dtype. It runs no operator, so it makes
    no profiler event and records nothing for autograd."""
    t = d._data if isinstance(d, NDArray) else d
    z = torch.zeros((t.shape[0], int(num_hidden)), dtype=t.dtype,
                    device=t.device)
    return NDArray(z) if isinstance(d, NDArray) else z


def _register_begin_state():
    from ..symbol import _OP_TABLE
    _OP_TABLE.setdefault("_begin_state", _begin_state_op)


_register_begin_state()


def _zeros_like_batch(x, num_hidden, name):
    """The deferred zero state of ``x``'s batch."""
    return Symbol(op=_begin_state_op, op_name="_begin_state", inputs=[x],
                  kwargs={"num_hidden": num_hidden}, name=name)


class BaseRNNCell(object):
    """The cells' base: parameters, begin states and ``unroll``."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._init_counter = -1
        self._counter = -1

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [s["shape"] for s in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    def begin_state(self, func=None, like=None, **kwargs):
        """The states of step 0. With ``like`` (a data symbol) the batch
        comes from it at bind; with ``func`` (``sym.zeros``) the states
        are ``func((batch_size, ...))``; otherwise they are variables
        named ``<prefix>begin_state_<i>``."""
        states = []
        for info in self.state_info:
            self._init_counter += 1
            name = "%sbegin_state_%d" % (self._prefix, self._init_counter)
            if like is not None:
                states.append(_zeros_like_batch(like, info["shape"][1], name))
            elif func is not None:
                shape = (kwargs.get("batch_size", 0),) + tuple(info["shape"][1:])
                assert shape[0] > 0, \
                    "begin_state without `like` needs batch_size > 0"
                states.append(func(shape))
            else:
                states.append(sym.var(name))
        return states

    def unpack_weights(self, args):
        """The weights of a checkpoint by gate: the cells keep them per
        matrix already, so a copy."""
        return dict(args)

    def pack_weights(self, args):
        return dict(args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """``length`` steps over ``inputs``: a (N, T, C) symbol (layout
        NTC), a (T, N, C) one (TNC) or a list of T (N, C) symbols. Returns
        (outputs, states): the outputs a list of T symbols, or one stacked
        along T with ``merge_outputs``."""
        self.reset()
        axis = layout.find("T")
        if isinstance(inputs, (list, tuple)):
            seq = list(inputs)
        else:
            seq = []
            for t in range(length):
                s = sym.slice_axis(inputs, axis=axis, begin=t, end=t + 1)
                seq.append(sym.squeeze(s, axis=axis))
        states = begin_state if begin_state is not None \
            else self.begin_state(like=seq[0])
        outputs = []
        for t in range(length):
            out, states = self(seq[t], states)
            outputs.append(out)
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, states


def _defer(v, shape_fn):
    """Give a cell weight its shape rule (from the data of the operator
    that consumes it first), so that bind makes it, as a layer op's own
    weights are made."""
    if not hasattr(v, "_deferred_shape_fn"):
        v._deferred_shape_fn = shape_fn
        v._is_param = True
    return v


class RNNCell(BaseRNNCell):
    """Elman cell: ``act(i2h(x) + h2h(h))``."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_", params=None):
        super().__init__(prefix, params)
        n = num_hidden
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = _defer(self.params.get("i2h_weight"), lambda s: (n, s[-1]))
        self._iB = _defer(self.params.get("i2h_bias"), lambda s: (n,))
        self._hW = _defer(self.params.get("h2h_weight"), lambda s: (n, n))
        self._hB = _defer(self.params.get("h2h_bias"), lambda s: (n,))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("",)

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=self._num_hidden, flatten=False,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=self._num_hidden, flatten=False,
                                 name="%sh2h" % name)
        output = sym.Activation(i2h + h2h, act_type=self._activation,
                                name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM, gates in the order i, f, c, o along the 4·num_hidden axis."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix, params)
        n = num_hidden
        self._num_hidden = num_hidden
        # forget_bias rides as the bias variable's __forget_bias__
        # attribute, as in the JAX package; initializers by name set the
        # biases to zeros
        self._iW = _defer(self.params.get("i2h_weight"), lambda s: (4 * n, s[-1]))
        self._iB = _defer(self.params.get("i2h_bias", __forget_bias__=forget_bias),
                          lambda s: (4 * n,))
        self._hW = _defer(self.params.get("h2h_weight"), lambda s: (4 * n, n))
        self._hB = _defer(self.params.get("h2h_bias"), lambda s: (4 * n,))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_i", "_f", "_c", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        n = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=4 * n, flatten=False,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=4 * n, flatten=False,
                                 name="%sh2h" % name)
        gates = i2h + h2h
        ig = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=0, end=n))
        fg = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=n, end=2 * n))
        gg = sym.tanh(sym.slice_axis(gates, axis=-1, begin=2 * n, end=3 * n))
        og = sym.sigmoid(sym.slice_axis(gates, axis=-1, begin=3 * n, end=4 * n))
        next_c = fg * states[1] + ig * gg
        next_h = og * sym.tanh(next_c)
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU, gates r, z, n along the 3·num_hidden axis."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix, params)
        n = num_hidden
        self._num_hidden = num_hidden
        self._iW = _defer(self.params.get("i2h_weight"), lambda s: (3 * n, s[-1]))
        self._iB = _defer(self.params.get("i2h_bias"), lambda s: (3 * n,))
        self._hW = _defer(self.params.get("h2h_weight"), lambda s: (3 * n, n))
        self._hB = _defer(self.params.get("h2h_bias"), lambda s: (3 * n,))

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ("_r", "_z", "_o")

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        n = self._num_hidden
        i2h = sym.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                 num_hidden=3 * n, flatten=False,
                                 name="%si2h" % name)
        h2h = sym.FullyConnected(states[0], weight=self._hW, bias=self._hB,
                                 num_hidden=3 * n, flatten=False,
                                 name="%sh2h" % name)
        ir = sym.slice_axis(i2h, axis=-1, begin=0, end=n)
        iz = sym.slice_axis(i2h, axis=-1, begin=n, end=2 * n)
        in_ = sym.slice_axis(i2h, axis=-1, begin=2 * n, end=3 * n)
        hr = sym.slice_axis(h2h, axis=-1, begin=0, end=n)
        hz = sym.slice_axis(h2h, axis=-1, begin=n, end=2 * n)
        hn = sym.slice_axis(h2h, axis=-1, begin=2 * n, end=3 * n)
        reset = sym.sigmoid(ir + hr)
        update = sym.sigmoid(iz + hz)
        newmem = sym.tanh(in_ + reset * hn)
        out = (sym.ones_like(update) - update) * newmem + update * states[0]
        return out, [out]


class SequentialRNNCell(BaseRNNCell):
    """A stack of cells, each one's output the next one's input."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []

    def add(self, cell):
        self._cells.append(cell)

    @property
    def state_info(self):
        return sum((c.state_info for c in self._cells), [])

    def begin_state(self, **kwargs):
        return sum((c.begin_state(**kwargs) for c in self._cells), [])

    def __call__(self, inputs, states):
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            inputs, st = cell(inputs, states[p:p + n])
            next_states.extend(st)
            p += n
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Each cell unrolled over the whole sequence in turn."""
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            states = None if begin_state is None else begin_state[p:p + n]
            inputs, st = cell.unroll(
                length, inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(st)
            p += n
        return inputs, next_states

    def reset(self):
        super().reset()
        for c in self._cells:
            c.reset()


class BidirectionalCell(BaseRNNCell):
    """``l_cell`` forward and ``r_cell`` backward over the sequence, their
    outputs concatenated at each step."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__("", params)
        self._l_cell = l_cell
        self._r_cell = r_cell
        self._output_prefix = output_prefix

    @property
    def state_info(self):
        return self._l_cell.state_info + self._r_cell.state_info

    def begin_state(self, **kwargs):
        return self._l_cell.begin_state(**kwargs) + \
            self._r_cell.begin_state(**kwargs)

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell can only be unrolled")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        axis = layout.find("T")
        if not isinstance(inputs, (list, tuple)):
            seq = [sym.squeeze(sym.slice_axis(inputs, axis=axis, begin=t,
                                              end=t + 1), axis=axis)
                   for t in range(length)]
        else:
            seq = list(inputs)
        nl = len(self._l_cell.state_info)
        lst = None if begin_state is None else begin_state[:nl]
        rst = None if begin_state is None else begin_state[nl:]
        l_out, l_states = self._l_cell.unroll(length, seq, begin_state=lst,
                                              layout=layout, merge_outputs=None)
        r_out, r_states = self._r_cell.unroll(length, list(reversed(seq)),
                                              begin_state=rst, layout=layout,
                                              merge_outputs=None)
        r_out = list(reversed(r_out))
        outputs = [sym.concat(l, r, dim=-1,
                              name="%st%d" % (self._output_prefix, t))
                   for t, (l, r) in enumerate(zip(l_out, r_out))]
        if merge_outputs:
            outputs = sym.stack(*outputs, axis=axis)
        return outputs, l_states + r_states

    def reset(self):
        super().reset()
        self._l_cell.reset()
        self._r_cell.reset()


class FusedRNNCell(BaseRNNCell):
    """MXNet's fused (cuDNN) cell, kept as the JAX package has it: the
    stacked, optionally bidirectional, composition of the mode's cell with
    the fused cell's prefixes (``<prefix>l<i>_``, ``<prefix>r<i>_``), and
    ``unfuse()`` the explicit ``SequentialRNNCell``. A cuDNN route is
    later work."""

    _MODES = {"rnn_relu": (RNNCell, {"activation": "relu"}),
              "rnn_tanh": (RNNCell, {"activation": "tanh"}),
              "lstm": (LSTMCell, {}),
              "gru": (GRUCell, {})}

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, prefix=None, params=None):
        if mode not in self._MODES:
            raise ValueError("mode must be one of %s" % list(self._MODES))
        prefix = prefix if prefix is not None else "%s_" % mode
        super().__init__(prefix, params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._stack = self.unfuse()

    def unfuse(self):
        cls, kw = self._MODES[self._mode]
        stack = SequentialRNNCell()
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    cls(self._num_hidden, prefix="%sl%d_" % (self._prefix, i),
                        **kw),
                    cls(self._num_hidden, prefix="%sr%d_" % (self._prefix, i),
                        **kw),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(cls(self._num_hidden,
                              prefix="%sl%d_" % (self._prefix, i), **kw))
            if self._dropout > 0 and i < self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_" % (self._prefix, i)))
        return stack

    @property
    def state_info(self):
        return self._stack.state_info

    def begin_state(self, **kwargs):
        return self._stack.begin_state(**kwargs)

    def __call__(self, inputs, states):
        return self._stack(inputs, states)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        return self._stack.unroll(length, inputs, begin_state=begin_state,
                                  layout=layout, merge_outputs=merge_outputs)


class DropoutCell(BaseRNNCell):
    """Dropout on the inputs (training only); no state."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix, params)
        self._dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self._dropout > 0:
            inputs = sym.Dropout(inputs, p=self._dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """A cell around ``base_cell``, with its states."""

    def __init__(self, base_cell):
        super().__init__(prefix="", params=None)
        self.base_cell = base_cell

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, **kwargs):
        return self.base_cell.begin_state(**kwargs)

    def reset(self):
        super().reset()
        self.base_cell.reset()


class ZoneoutCell(ModifierCell):
    """Zoneout on the outputs: each unit keeps the previous step's output
    with probability ``zoneout_outputs`` (training only). The states pass
    through as the JAX package passes them (``zoneout_states`` is
    stored)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def reset(self):
        super().reset()
        self._prev_output = None

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        if self.zoneout_outputs > 0:
            prev = self._prev_output if self._prev_output is not None \
                else sym.zeros_like(out)
            mask = sym.Dropout(sym.ones_like(out), p=self.zoneout_outputs)
            # Dropout scales by 1/(1-p): cut back to a 0/1 keep mask
            keep = sym.minimum(mask, sym.ones_like(mask))
            out = keep * out + (sym.ones_like(keep) - keep) * prev
        self._prev_output = out
        return out, next_states


class ResidualCell(ModifierCell):
    """``base_cell``'s output plus its input."""

    def __call__(self, inputs, states):
        out, next_states = self.base_cell(inputs, states)
        return out + inputs, next_states
