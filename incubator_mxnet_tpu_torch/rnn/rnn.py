"""RNN checkpoints (counterpart of ``incubator_mxnet_tpu/rnn/rnn.py``;
MXNet's ``python/mxnet/rnn/rnn.py``).

MXNet packs and unpacks the fused cells' parameter blobs around
``save_checkpoint``/``load_checkpoint``. The cells here keep one array per
gate matrix (``FusedRNNCell`` is a stack of plain cells), so packing is a
copy and these are ``model``'s checkpoints, which either package reads.
"""
from __future__ import annotations

from .. import model as _model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _cells_list(cells):
    return cells if isinstance(cells, (list, tuple)) else [cells]


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """Write ``<prefix>-symbol.json`` and ``<prefix>-%04d.params``."""
    for cell in _cells_list(cells):
        arg_params = cell.unpack_weights(arg_params)
    _model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint."""
    sym, arg, aux = _model.load_checkpoint(prefix, epoch)
    for cell in _cells_list(cells):
        arg = cell.pack_weights(arg)
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """An epoch-end callback that saves every ``period`` epochs."""
    period = max(1, period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback
