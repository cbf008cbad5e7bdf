"""The fused RNN operator (counterpart of
``incubator_mxnet_tpu/ndarray/rnn_op.py``, MXNet's cuDNN-backed ``RNN``).

``RNN`` takes MXNet's flat parameter vector in its packed layout (every
layer's and direction's i2h and h2h weights first, then their biases:
``_dims``), and runs modes ``rnn_relu``, ``rnn_tanh``, ``lstm`` and
``gru`` over TNC data, multi-layer and bidirectional. The gate orders are
MXNet's (i, f, g, o; r, z, n with ``n = tanh(x·Wxnᵀ + bxn + r ⊙ (h·Whnᵀ +
bhn))``), each layer with its two biases.

``_rnn`` is the recurrence itself, shared with ``gluon.rnn``'s layers:
one layer (both directions) a call of ``torch.lstm``/``torch.gru``/
``torch.rnn_tanh``/``torch.rnn_relu``, whose gate orders and biases are
MXNet's (cuDNN's fused RNN on the card, the op MXNet's own ``RNN``
called; ATen's loop on the CPU). On the H100 it ran the full-width LSTM
LM's step 2.3x faster captured and 4.1x faster eager than the JAX
package's arithmetic step by step (``chip_smoke.py``'s ``lstm_lm`` phase
times both). Between stacked layers (never after the last), in training,
the output is multiplied by a dropout mask drawn once per call from
``nd.random``'s generator of the device; autograd keeps that mask for the
backward, and a captured step's graph replays a fresh draw (the generator
is registered with the capture).
"""
from __future__ import annotations

import math

import torch

from .. import autograd
from . import random as _random
from .ndarray import _op

__all__ = ["RNN", "rnn_param_size"]

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "gru": 3, "lstm": 4}
_FUSED = {"lstm": torch.lstm, "gru": torch.gru, "rnn_tanh": torch.rnn_tanh,
          "rnn_relu": torch.rnn_relu}


def _dims(mode, input_size, state_size, num_layers, bidirectional):
    """(kind, layer, direction, shape) of every array in the packed vector,
    in packing order: all weights ("wi", "wh"), then all biases ("bi",
    "bh")."""
    g = _GATES[mode]
    d_n = 2 if bidirectional else 1
    shapes = []
    for layer in range(num_layers):
        isz = input_size if layer == 0 else d_n * state_size
        for d in range(d_n):
            shapes.append(("wi", layer, d, (g * state_size, isz)))
            shapes.append(("wh", layer, d, (g * state_size, state_size)))
    for layer in range(num_layers):
        for d in range(d_n):
            shapes.append(("bi", layer, d, (g * state_size,)))
            shapes.append(("bh", layer, d, (g * state_size,)))
    return shapes


def rnn_param_size(mode, input_size, state_size, num_layers=1,
                   bidirectional=False):
    """The length of the packed parameter vector."""
    return sum(math.prod(shape) for _, _, _, shape in
               _dims(mode, input_size, state_size, num_layers, bidirectional))


def _unpack(params, shapes):
    """{(kind, layer, direction): a view of ``params``}."""
    out, off = {}, 0
    for kind, layer, d, shape in shapes:
        n = math.prod(shape)
        out[(kind, layer, d)] = params[off:off + n].reshape(shape)
        off += n
    return out


def _fused_layer(mode, x, h0, c0, weights):
    """One layer, every direction, through torch's fused RNN."""
    flat = [w for direction in weights for w in direction]
    bidirectional = len(weights) == 2
    train = torch.is_grad_enabled()
    if mode == "lstm":
        return _FUSED[mode](x, (h0, c0), flat, True, 1, 0.0, train,
                            bidirectional, False)
    out, h = _FUSED[mode](x, h0, flat, True, 1, 0.0, train, bidirectional,
                          False)
    return out, h, None


def _dropout_mask(shape, keep, device):
    """An inter-layer dropout's keep mask: True with probability ``keep``,
    drawn from ``nd.random``'s generator of ``device``."""
    return torch.rand(shape, generator=_random._generator(device),
                      device=device) < keep


def _rnn(x, h0, c0, weights, mode, num_layers, bidirectional, p, training):
    """The stacked recurrence over TNC ``x`` from states (L·D, N, H):
    ``weights[(kind, layer, direction)]`` as ``_unpack`` gives them.
    Returns (output (T, N, D·H), h_T, c_T or None)."""
    d_n = 2 if bidirectional else 1
    out, hs, cs = x, [], []
    for layer in range(num_layers):
        sl = slice(layer * d_n, (layer + 1) * d_n)
        out, h, c = _fused_layer(mode, out, h0[sl], None if c0 is None
                                 else c0[sl],
                                 [tuple(weights[(k, layer, d)]
                                        for k in ("wi", "wh", "bi", "bh"))
                                  for d in range(d_n)])
        hs.append(h)
        cs.append(c)
        if training and p > 0 and layer != num_layers - 1:
            keep = 1.0 - p
            mask = autograd._remat_keep(
                lambda: _dropout_mask(out.shape, keep, out.device))
            out = out * mask.to(out.dtype) / keep
    return (out, torch.cat(hs), None if c0 is None else torch.cat(cs))


@_op
def RNN(data, parameters, state, state_cell=None, state_size=None,
        num_layers=1, mode="lstm", bidirectional=False, p=0.0,
        state_outputs=False, **kw):
    """``data`` (T, N, I), the packed ``parameters``, ``state`` (and for
    lstm ``state_cell``), each (L·D, N, H) or None for zeros. Returns the
    output (T, N, D·H), or with ``state_outputs`` [output, h_T(, c_T)].
    Inter-layer dropout ``p`` applies in training
    (``autograd.is_training()``), its masks drawn once, here."""
    if mode not in _GATES:
        raise ValueError("unsupported RNN mode %r" % (mode,))
    if not state_size:
        raise ValueError("RNN needs state_size")
    t, n, i = data.shape
    d_n = 2 if bidirectional else 1
    zeros = (num_layers * d_n, n, state_size)
    if state is None:
        state = data.new_zeros(zeros)
    if mode == "lstm" and state_cell is None:
        state_cell = data.new_zeros(zeros)
    weights = _unpack(parameters, _dims(mode, i, state_size, num_layers,
                                        bidirectional))
    out, h, c = _rnn(data, state, state_cell if mode == "lstm" else None,
                     weights, mode, num_layers, bidirectional, p,
                     autograd.is_training())
    if not state_outputs:
        return out
    return [out, h, c] if mode == "lstm" else [out, h]
