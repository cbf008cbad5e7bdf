"""Helper module of the embedded-interpreter graph C API
(``native/src/c_predict_api.cc`` MXTPUSymbol* and MXTPUExecutor*;
counterpart of ``incubator_mxnet_tpu/native/_graph_embed.py``; ref
include/mxnet/c_api.h MXSymbolCreateAtomicSymbol, MXSymbolCompose and
MXExecutorSimpleBindEx).

A C frontend builds and runs a graph through it: compose symbols,
``simple_bind`` an executor, forward and backward, read and update the
bound arrays. Handles crossing the ABI are opaque PyObjects: the port's
``Symbol``s, an uncomposed atomic-op token (``_Atomic``), ``Executor``s and
the NDArrays of the invoke tier. As with ``MXSymbolCompose``, composing
fills the operator inputs not given with auto-named variables (fc1 ->
fc1_weight/fc1_bias) through the port's ``sym`` layer ops; as with
``MXExecutorSimpleBindEx``, ``simple_bind`` allocates the argument arrays
from the shapes given (and the layer parameters' inferred shapes) and the
gradient buffers by ``grad_req``, on the call's ``capi_context()``.
"""
from __future__ import annotations

import json

from . import in_capi_context

__all__ = ["sym_variable", "sym_atomic", "sym_compose", "sym_list_arguments",
           "sym_list_outputs", "sym_tojson", "executor_simple_bind",
           "executor_forward", "executor_num_outputs", "executor_output",
           "executor_backward", "executor_arg", "executor_arg_grad"]


class _Atomic:
    """An op and its attributes awaiting composition
    (MXSymbolCreateAtomicSymbol)."""

    def __init__(self, op_name, attrs):
        self.op_name = op_name
        self.attrs = attrs


def _sym_mod():
    from .. import symbol as sym
    return sym


def sym_variable(name):
    return _sym_mod().Variable(name)


def sym_atomic(op_name, attrs_json):
    sym = _sym_mod()
    if not hasattr(sym, op_name):
        raise ValueError("unknown symbol op %r" % op_name)
    attrs = json.loads(attrs_json) if attrs_json else {}
    return _Atomic(op_name, attrs)


def sym_compose(atomic, name, keys, args):
    """MXSymbolCompose: bind named symbol inputs and attributes into a
    node."""
    if not isinstance(atomic, _Atomic):
        raise TypeError("compose target must be an uncomposed atomic "
                        "symbol (got %r)" % type(atomic).__name__)
    fn = getattr(_sym_mod(), atomic.op_name)
    kwargs = dict(atomic.attrs)
    if name:
        kwargs["name"] = name
    positional = []
    for k, a in zip(keys, args):
        if k:
            kwargs[k] = a
        else:
            positional.append(a)
    return fn(*positional, **kwargs)


def sym_list_arguments(s):
    return json.dumps(list(s.list_arguments()))


def sym_list_outputs(s):
    return json.dumps(list(s.list_outputs()))


def sym_tojson(s):
    return s.tojson()


@in_capi_context
def executor_simple_bind(s, shapes_json, grad_req):
    shapes = {k: tuple(int(d) for d in v)
              for k, v in json.loads(shapes_json).items()}
    return s.simple_bind(grad_req=grad_req, **shapes)


@in_capi_context
def executor_forward(ex, is_train, names, arrays):
    ex.forward(is_train=bool(is_train), **dict(zip(names, arrays)))


def executor_num_outputs(ex):
    return len(ex.outputs)


def executor_output(ex, i):
    return ex.outputs[i]


@in_capi_context
def executor_backward(ex, head_grads):
    ex.backward(head_grads if head_grads else None)


def executor_arg(ex, name):
    """A bound argument, or an auxiliary state (BatchNorm's moving
    statistics, arguments in the JAX package)."""
    if name in ex.arg_dict:
        return ex.arg_dict[name]
    if name in ex.aux_dict:
        return ex.aux_dict[name]
    raise KeyError("no bound array %r" % name)


def executor_arg_grad(ex, name):
    g = ex.grad_dict.get(name)
    if g is None:
        raise KeyError("no grad buffer for %r (grad_req/null or not an "
                       "argument)" % name)
    return g
