"""Custom operators: ``CustomOp``/``CustomOpProp``, ``register`` and
``Custom`` (counterpart of ``incubator_mxnet_tpu/operator.py``; MXNet's
``python/mxnet/operator.py`` and ``src/operator/custom/custom.cc``).

A custom operator's ``forward``/``backward`` are Python over NDArrays,
dispatched directly (MXNet trampolines them through its engine); under
``autograd.record()`` the pair is one node of the tape through
``autograd.Function``. ``req`` is "write" for every output and input
gradient, and ``assign`` writes, adds or skips by it, as in MXNet.

The operator runs eagerly, every call: a captured ``jit.TrainStep`` or
``EvalStep`` that meets one runs that signature uncaptured, as it runs a
``shard_map`` step (``parallel.compat.note_host_body``), where the JAX
package's jit would trace the Python once. Use torch operators (or an
``autograd.Function`` over them) for custom math on a captured path.
"""
from __future__ import annotations

from . import autograd
from . import ndarray as nd
from .ndarray import NDArray

__all__ = ["CustomOp", "CustomOpProp", "register", "get_all_registered",
           "Custom"]

_REGISTRY = {}


class CustomOp:
    """Base class of custom operator implementations (MXNet's
    operator.py:141)."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by ``req`` (MXNet's operator.py:159):
        "write"/"inplace" replace, "add" accumulates, "null" skips."""
        if req == "null":
            return
        data = src._data if isinstance(src, NDArray) else src
        if req in ("write", "inplace"):
            dst._data = data
        elif req == "add":
            dst._data = dst._data + data
        else:
            raise ValueError("unknown req %r" % req)


class CustomOpProp:
    """A custom operator's properties: arguments, outputs and shapes
    (MXNet's operator.py:524)."""

    def __init__(self, need_top_grad=True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self):
        return ["data"]

    def list_outputs(self):
        return ["output"]

    def list_auxiliary_states(self):
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        t = in_type[0]
        return in_type, [t] * len(self.list_outputs()), \
            [t] * len(self.list_auxiliary_states())

    def create_operator(self, ctx, in_shapes, in_dtypes):
        raise NotImplementedError


def register(reg_name):
    """Decorator registering a CustomOpProp under ``op_type`` (MXNet's
    operator.py:791)."""
    def do_register(prop_cls):
        _REGISTRY[reg_name] = prop_cls
        return prop_cls
    return do_register


def get_all_registered():
    return dict(_REGISTRY)


class _CustomFunction(autograd.Function):
    def __init__(self, prop, op, n_in, n_out, aux):
        super().__init__()
        self.prop = prop
        self.op = op
        self.n_in = n_in
        self.n_out = n_out
        self.aux = aux

    def forward(self, *inputs):
        self._in_data = list(inputs)
        ctx = inputs[0].context
        out_shapes = self.prop.infer_shape([list(x.shape) for x in inputs])[1]
        out_types = self.prop.infer_type([x.dtype for x in inputs])[1]
        self._out_data = [nd.zeros(tuple(s), ctx=ctx, dtype=t)
                          for s, t in zip(out_shapes, out_types)]
        self.op.forward(is_train=autograd.is_training(),
                        req=["write"] * self.n_out,
                        in_data=self._in_data, out_data=self._out_data,
                        aux=self.aux)
        outs = tuple(self._out_data)
        return outs[0] if len(outs) == 1 else outs

    def backward(self, *output_grads):
        in_grad = [nd.zeros(x.shape, ctx=x.context, dtype=x.dtype)
                   for x in self._in_data]
        ograds = [g if g is not None else
                  nd.zeros(o.shape, ctx=o.context, dtype=o.dtype)
                  for g, o in zip(output_grads, self._out_data)]
        self.op.backward(req=["write"] * self.n_in, out_grad=ograds,
                         in_data=self._in_data, out_data=self._out_data,
                         in_grad=in_grad, aux=self.aux)
        return tuple(in_grad)


def Custom(*inputs, op_type, **kwargs):
    """``nd.Custom``: run a registered custom operator. Extra keywords go
    to the registered CustomOpProp's constructor (strings in MXNet; here
    the values pass as they are)."""
    if op_type not in _REGISTRY:
        raise ValueError("custom op %r not registered (use "
                         "@mx.operator.register)" % op_type)
    prop = _REGISTRY[op_type](**kwargs)
    n_in = len(prop.list_arguments())
    if len(inputs) != n_in:
        raise ValueError("custom op %r expects %d inputs (%s), got %d"
                         % (op_type, n_in, prop.list_arguments(), len(inputs)))
    from .parallel import compat
    compat.note_host_body()
    inputs = [x if isinstance(x, NDArray) else NDArray(x) for x in inputs]
    aux = []
    op = prop.create_operator(inputs[0].context,
                              [list(x.shape) for x in inputs],
                              [x.dtype for x in inputs])
    fn = _CustomFunction(prop, op, n_in, len(prop.list_outputs()), aux)
    return fn(*inputs)
