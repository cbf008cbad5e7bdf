"""The ``sym`` namespace: symbolic mirrors of the ``nd`` operators
(counterpart of ``incubator_mxnet_tpu/symbol/__init__.py``).

As in the JAX package, one registry drives both namespaces: every public
``nd`` callable outside the exclusion table ``_SYM_EXCLUDE`` is symbolized
(``_symbolize``), so ``mx.sym`` mirrors the whole of the port's ``nd``.
Layer ops (``FullyConnected``, ``Convolution``, ...) are defined here
instead: they make their parameter variables (``<name>_weight``, ...) with
a rule that gives each variable's shape from the data's, so ``simple_bind``
allocates them from the data shape alone (``_deferred_rules`` restores the
rules on a graph read back from JSON). The loss layers take MXNet's
keywords (``normalization``, ``multi_output``, ...), which the port's
``nd`` operators honour; a keyword not given stays out of the graph's
attributes, so the JSON is the JAX package's.
"""
from __future__ import annotations

import numpy as onp

from .. import ndarray as nd
from .symbol import (Symbol, Group, Variable, var, load, load_json, zeros, ones,
                     _auto_name)

__all__ = ["Symbol", "Group", "Variable", "var", "load", "load_json", "zeros",
           "ones"]

_OP_TABLE = {}


def _deferred_rules(op_name, kwargs):
    """The shape rules of a layer op's parameter variables, by op and
    attributes (input index → shape_fn(data_shape)), for graph JSON read
    back."""
    if op_name == "FullyConnected":
        nh = kwargs.get("num_hidden")
        flatten_ = kwargs.get("flatten", True)

        def w_shape(s):
            inu = int(onp.prod(s[1:])) if flatten_ else s[-1]
            return (nh, inu)
        return {1: w_shape, 2: lambda s: (nh,)}
    if op_name == "Convolution":
        nf = kwargs.get("num_filter")
        kernel = tuple(kwargs.get("kernel"))
        ng = kwargs.get("num_group", 1)
        return {1: lambda s: (nf, s[1] // ng) + kernel, 2: lambda s: (nf,)}
    if op_name in ("BatchNorm",):
        ax = kwargs.get("axis", 1)
        c = lambda s: (s[ax],)
        return {1: c, 2: c, 3: c, 4: c}
    if op_name == "LayerNorm":
        ax = kwargs.get("axis", -1)
        c = lambda s: (s[ax],)
        return {1: c, 2: c}
    if op_name == "Embedding":
        return {1: lambda s: (kwargs.get("input_dim"), kwargs.get("output_dim"))}
    if op_name == "Deconvolution":
        nf = kwargs.get("num_filter")
        kernel = tuple(kwargs.get("kernel"))
        ng = kwargs.get("num_group", 1)
        return {1: lambda s: (s[1], nf // ng) + kernel, 2: lambda s: (nf,)}
    if op_name in ("GroupNorm", "InstanceNorm"):
        c = lambda s: (s[1],)
        return {1: c, 2: c}
    return None


def _op_lookup(name):
    if name in _OP_TABLE:
        return _OP_TABLE[name]
    return getattr(nd, name)


def _flat_adapter(fn, spec):
    """Rebuild list-of-array positional arguments from the flattened
    Symbol inputs: spec[i] is None for a plain argument, "N" for an omitted
    optional one, or the list's length. The spec travels in kwargs as
    ``__arg_spec__``, so graph JSON round-trips."""
    def call(*vals, **kw):
        kw.pop("__arg_spec__", None)
        it = iter(vals)
        rebuilt = []
        for s in spec:
            if s is None:
                rebuilt.append(next(it))
            elif s == "N":
                rebuilt.append(None)
            else:
                rebuilt.append([next(it) for _ in range(s)])
        return fn(*rebuilt, **kw)
    return call


def _symbolize(fn, op_name):
    """A Symbol builder over an ``nd`` function."""

    def sym_fn(*args, name=None, **kwargs):
        inputs, spec = [], []
        for a in args:
            if isinstance(a, Symbol):
                inputs.append(a)
                spec.append(None)
            elif a is None:         # an absent optional input (RNN state)
                spec.append("N")
            elif isinstance(a, (list, tuple)) and a and \
                    all(isinstance(x, Symbol) for x in a):
                inputs.extend(a)
                spec.append(len(a))
            else:
                raise TypeError("%s: positional args must be Symbols "
                                "(or lists of Symbols)" % op_name)
        if any(s is not None for s in spec):
            kwargs["__arg_spec__"] = tuple(spec)
            op = _flat_adapter(fn, spec)
        else:
            op = fn
        return Symbol(op=op, op_name=op_name, inputs=inputs, kwargs=kwargs,
                      name=name)

    sym_fn.__name__ = op_name
    _OP_TABLE[op_name] = fn
    return sym_fn


# ---------------------------------------------------- registry unification
# Every public nd callable not in the exclusion table below is symbolized;
# the layer ops further down override their plain symbolized forms.
_SYM_EXCLUDE = {
    # host-side constructors / serialization / interop: no graph-node
    # semantics (a Symbol is built from var() and operators)
    "array": "host constructor; use sym.var + bind",
    "empty": "uninitialized host constructor",
    "save": "file io (Symbol.save writes graph JSON instead)",
    "load": "file io (sym.load reads graph JSON instead)",
    "from_dlpack": "zero-copy interop is eager-only",
    "from_numpy": "zero-copy interop is eager-only",
    "to_dlpack_for_read": "zero-copy interop is eager-only",
    "to_dlpack_for_write": "zero-copy interop is eager-only",
    "load_frombuffer": "file io",
    "imdecode": "host-side jpeg decode (io pipeline, not an operator)",
    "waitall": "engine sync primitive, not an operator",
    "rnn_param_size": "shape helper returning a python int",
}

_g = globals()


def _auto_register_from_nd():
    from ..base import public_op_names
    added = []
    for _n in public_op_names(nd, exclude=_SYM_EXCLUDE):
        if _n in _g:
            continue
        _g[_n] = _symbolize(getattr(nd, _n), _n)
        added.append(_n)
    return added


__all__ += _auto_register_from_nd()

# the node names of the operator sugar (Symbol.__add__ etc.), so graph JSON
# holding them reloads; the *_scalar forms resolve through symbol.py
from .symbol import _scalar_binop_fn as _sbf  # noqa: E402

for _opname, _fn in [("_plus", nd.add), ("_minus", nd.subtract),
                     ("_mul", nd.multiply), ("_div", nd.divide),
                     ("_pow", nd.power), ("_greater", nd.greater),
                     ("_greater_equal", nd.greater_equal),
                     ("_lesser", nd.lesser), ("_lesser_equal", nd.lesser_equal),
                     ("_mod", nd.modulo)]:
    _OP_TABLE[_opname] = _fn
    _OP_TABLE[_opname + "_scalar"] = _sbf(_fn)
_OP_TABLE["negative"] = nd.negative
Concat = _g["concat"]
SliceChannel = _g["split"]
Flatten = _g["flatten"]
Cast = _g["cast"]


# -------------------------------------------------------------- layer ops
def _param_var(base_name, suffix, shape_fn):
    v = var("%s_%s" % (base_name, suffix))
    v._deferred_shape_fn = shape_fn
    v._is_param = True
    return v


def FullyConnected(data=None, weight=None, bias=None, num_hidden=None,
                   no_bias=False, flatten=True, name=None, **kw):
    """y = x Wᵀ + b, making ``<name>_weight`` and ``<name>_bias``."""
    name = name or _auto_name("fullyconnected")

    def w_shape(in_shape):
        in_units = int(onp.prod(in_shape[1:])) if flatten else in_shape[-1]
        return (num_hidden, in_units)

    weight = weight if weight is not None else _param_var(name, "weight", w_shape)
    inputs = [data, weight]
    if not no_bias:
        bias = bias if bias is not None else _param_var(
            name, "bias", lambda s: (num_hidden,))
        inputs.append(bias)
    kwargs = dict(num_hidden=num_hidden, no_bias=no_bias, flatten=flatten)
    return Symbol(op=nd.FullyConnected, op_name="FullyConnected", inputs=inputs,
                  kwargs=kwargs, name=name)


def Convolution(data=None, weight=None, bias=None, kernel=None, stride=(1, 1),
                dilate=(1, 1), pad=(0, 0), num_filter=None, num_group=1,
                no_bias=False, layout="NCHW", name=None, **kw):
    name = name or _auto_name("convolution")

    def w_shape(in_shape):
        return (num_filter, in_shape[1] // num_group) + tuple(kernel)

    weight = weight if weight is not None else _param_var(name, "weight", w_shape)
    inputs = [data, weight]
    if not no_bias:
        bias = bias if bias is not None else _param_var(
            name, "bias", lambda s: (num_filter,))
        inputs.append(bias)
    kwargs = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad,
                  num_filter=num_filter, num_group=num_group, no_bias=no_bias)
    return Symbol(op=nd.Convolution, op_name="Convolution", inputs=inputs,
                  kwargs=kwargs, name=name)


def BatchNorm(data=None, gamma=None, beta=None, moving_mean=None, moving_var=None,
              eps=1e-5, momentum=0.9, fix_gamma=True, use_global_stats=False,
              axis=1, name=None, **kw):
    """Batch norm making ``gamma``/``beta`` arguments and ``moving_mean``/
    ``moving_var`` auxiliary states (updated in place in training)."""
    name = name or _auto_name("batchnorm")
    c_shape = lambda s: (s[axis],)
    gamma = gamma if gamma is not None else _param_var(name, "gamma", c_shape)
    beta = beta if beta is not None else _param_var(name, "beta", c_shape)
    moving_mean = moving_mean if moving_mean is not None else _param_var(
        name, "moving_mean", c_shape)
    moving_var = moving_var if moving_var is not None else _param_var(
        name, "moving_var", c_shape)
    moving_mean._is_aux = True
    moving_var._is_aux = True
    kwargs = dict(eps=eps, momentum=momentum, fix_gamma=fix_gamma,
                  use_global_stats=use_global_stats, axis=axis)
    return Symbol(op=nd.BatchNorm, op_name="BatchNorm",
                  inputs=[data, gamma, beta, moving_mean, moving_var],
                  kwargs=kwargs, name=name)


def Activation(data=None, act_type="relu", name=None, **kw):
    return Symbol(op=nd.Activation, op_name="Activation", inputs=[data],
                  kwargs=dict(act_type=act_type), name=name)


def LeakyReLU(data=None, act_type="leaky", slope=0.25, name=None, **kw):
    return Symbol(op=nd.LeakyReLU, op_name="LeakyReLU", inputs=[data],
                  kwargs=dict(act_type=act_type, slope=slope), name=name)


def Pooling(data=None, kernel=None, pool_type="max", global_pool=False,
            stride=None, pad=None, pooling_convention="valid", name=None, **kw):
    kwargs = dict(kernel=kernel, pool_type=pool_type, global_pool=global_pool,
                  stride=stride, pad=pad, pooling_convention=pooling_convention)
    return Symbol(op=nd.Pooling, op_name="Pooling", inputs=[data], kwargs=kwargs,
                  name=name)


def Dropout(data=None, p=0.5, name=None, **kw):
    return Symbol(op=nd.Dropout, op_name="Dropout", inputs=[data],
                  kwargs=dict(p=p), name=name)


# MXNet's keywords of the loss layers: kept in the graph when given
_LOSS_KEYWORDS = ("ignore_label", "use_ignore", "multi_output",
                  "preserve_shape", "normalization", "out_grad",
                  "smooth_alpha")


def _loss_kwargs(grad_scale, kw):
    kwargs = dict(grad_scale=grad_scale)
    kwargs.update((k, kw[k]) for k in _LOSS_KEYWORDS if k in kw)
    return kwargs


def SoftmaxOutput(data=None, label=None, grad_scale=1.0, name=None, **kw):
    """Softmax with MXNet's loss-layer backward; the label variable is
    ``<name>_label`` (``softmax_label`` by default)."""
    name = name or "softmax"
    label = label if label is not None else var(name + "_label")
    label._is_label = True
    return Symbol(op=nd.SoftmaxOutput, op_name="SoftmaxOutput",
                  inputs=[data, label], kwargs=_loss_kwargs(grad_scale, kw),
                  name=name)


def Embedding(data=None, weight=None, input_dim=None, output_dim=None,
              name=None, **kw):
    name = name or _auto_name("embedding")
    weight = weight if weight is not None else _param_var(
        name, "weight", lambda s: (input_dim, output_dim))
    return Symbol(op=nd.Embedding, op_name="Embedding", inputs=[data, weight],
                  kwargs=dict(input_dim=input_dim, output_dim=output_dim),
                  name=name)


def LayerNorm(data=None, gamma=None, beta=None, axis=-1, eps=1e-5, name=None, **kw):
    name = name or _auto_name("layernorm")
    c_shape = lambda s: (s[axis],)
    gamma = gamma if gamma is not None else _param_var(name, "gamma", c_shape)
    beta = beta if beta is not None else _param_var(name, "beta", c_shape)
    return Symbol(op=nd.LayerNorm, op_name="LayerNorm",
                  inputs=[data, gamma, beta], kwargs=dict(axis=axis, eps=eps),
                  name=name)


def Deconvolution(data=None, weight=None, bias=None, kernel=None, stride=(1, 1),
                  dilate=(1, 1), pad=(0, 0), adj=(0, 0), num_filter=None,
                  num_group=1, no_bias=False, target_shape=None, name=None, **kw):
    """Transposed convolution; the weight is (in_channels,
    num_filter/num_group, *kernel)."""
    name = name or _auto_name("deconvolution")

    def w_shape(in_shape):
        return (in_shape[1], num_filter // num_group) + tuple(kernel)

    weight = weight if weight is not None else _param_var(name, "weight", w_shape)
    inputs = [data, weight]
    if not no_bias:
        bias = bias if bias is not None else _param_var(
            name, "bias", lambda s: (num_filter,))
        inputs.append(bias)
    kwargs = dict(kernel=kernel, stride=stride, dilate=dilate, pad=pad, adj=adj,
                  num_filter=num_filter, num_group=num_group, no_bias=no_bias,
                  target_shape=target_shape)
    return Symbol(op=nd.Deconvolution, op_name="Deconvolution", inputs=inputs,
                  kwargs=kwargs, name=name)


def GroupNorm(data=None, gamma=None, beta=None, num_groups=1, eps=1e-5,
              name=None, **kw):
    name = name or _auto_name("groupnorm")
    c_shape = lambda s: (s[1],)
    gamma = gamma if gamma is not None else _param_var(name, "gamma", c_shape)
    beta = beta if beta is not None else _param_var(name, "beta", c_shape)
    return Symbol(op=nd.GroupNorm, op_name="GroupNorm",
                  inputs=[data, gamma, beta],
                  kwargs=dict(num_groups=num_groups, eps=eps), name=name)


def InstanceNorm(data=None, gamma=None, beta=None, eps=1e-3, name=None, **kw):
    name = name or _auto_name("instancenorm")
    c_shape = lambda s: (s[1],)
    gamma = gamma if gamma is not None else _param_var(name, "gamma", c_shape)
    beta = beta if beta is not None else _param_var(name, "beta", c_shape)
    return Symbol(op=nd.InstanceNorm, op_name="InstanceNorm",
                  inputs=[data, gamma, beta], kwargs=dict(eps=eps), name=name)


def _make_regression_output(op_name, nd_fn):
    def builder(data=None, label=None, grad_scale=1.0, name=None, **kw):
        name = name or _auto_name(op_name.lower())
        label = label if label is not None else var(name + "_label")
        label._is_label = True
        return Symbol(op=nd_fn, op_name=op_name, inputs=[data, label],
                      kwargs=dict(grad_scale=grad_scale), name=name)
    builder.__name__ = op_name
    return builder


LinearRegressionOutput = _make_regression_output(
    "LinearRegressionOutput", nd.LinearRegressionOutput)
LogisticRegressionOutput = _make_regression_output(
    "LogisticRegressionOutput", nd.LogisticRegressionOutput)
MAERegressionOutput = _make_regression_output(
    "MAERegressionOutput", nd.MAERegressionOutput)


for _n in ["FullyConnected", "Convolution", "BatchNorm", "Activation", "LeakyReLU",
           "Pooling", "Dropout", "SoftmaxOutput", "Embedding", "LayerNorm",
           "LinearRegressionOutput", "Deconvolution", "GroupNorm",
           "InstanceNorm"]:
    __all__.append(_n)
    _OP_TABLE[_n] = getattr(nd, _n, None)

# the legacy and backend aliases are the parameter-making builders
BatchNorm_v1 = CuDNNBatchNorm = BatchNorm
Convolution_v1 = Convolution
Pooling_v1 = Pooling

from . import contrib  # noqa: E402  (symbolic control flow)

pow = _g["power"]  # noqa: A001


def split_v2(data, indices_or_sections, axis=0, squeeze_axis=False, name=None):
    """Split at static sections or indices (graph attributes)."""
    return Symbol(op=nd.split_v2, op_name="split_v2", inputs=[data],
                  kwargs=dict(indices_or_sections=indices_or_sections,
                              axis=axis, squeeze_axis=squeeze_axis),
                  name=name)


def eye(N, M=None, k=0, dtype="float32", **kw):
    return Symbol(op=lambda: nd.eye(N, M or 0, k, dtype=dtype), op_name="eye",
                  inputs=[])


def full(shape, val, dtype="float32", **kw):
    return Symbol(op=lambda: nd.full(shape, val, dtype=dtype), op_name="full",
                  inputs=[])


def arange(start, stop=None, step=1.0, repeat=1, dtype="float32", name=None, **kw):
    return Symbol(op=lambda: nd.arange(start, stop, step, repeat=repeat,
                                       dtype=dtype),
                  op_name="arange", inputs=[], name=name)


def linspace(start, stop, num, endpoint=True, dtype="float32", **kw):
    return Symbol(op=lambda: nd.array(onp.linspace(
        start, stop, num, endpoint=endpoint).astype(dtype)),
        op_name="linspace", inputs=[])


__all__ += ["pow", "split_v2", "eye", "full", "arange", "linspace"]


# -------------------------------------------------------- sub-namespaces
# (mx.sym.linalg / mx.sym.random / mx.sym.sparse)
class _SymNS:
    def __init__(self, name, table):
        self.__name__ = "symbol." + name
        for k, v in table.items():
            setattr(self, k, v)


def _sym_linalg_ns():
    from ..ndarray import linalg as _ndl
    table = {}
    for k in dir(_ndl):
        fn = getattr(_ndl, k)
        if k.startswith("_") or not callable(fn):
            continue
        table[k] = _symbolize(fn, "linalg_" + k)
        _OP_TABLE["linalg_" + k] = fn
    return _SymNS("linalg", table)


def _sym_random_ns():
    from ..ndarray import random as _ndr

    def make_creation(fn, opname):
        def sym_fn(*args, name=None, **kwargs):
            # a creation op: no Symbol inputs, its arguments in the thunk
            return Symbol(op=lambda: fn(*args, **kwargs), op_name=opname,
                          inputs=[], name=name)
        sym_fn.__name__ = opname
        return sym_fn

    table = {}
    for k in ["uniform", "normal", "randn", "randint", "exponential",
              "gamma", "poisson", "negative_binomial",
              "generalized_negative_binomial", "bernoulli"]:
        if hasattr(_ndr, k):
            table[k] = make_creation(getattr(_ndr, k), "random_" + k)
    for k in ["multinomial", "shuffle"]:  # ops over an array
        if hasattr(_ndr, k):
            table[k] = _symbolize(getattr(_ndr, k), "random_" + k)
            _OP_TABLE["random_" + k] = getattr(_ndr, k)
    return _SymNS("random", table)


def _sym_sparse_ns():
    """The dense-compatible sparse ops; storage conversion is eager-only,
    as in the JAX package."""
    table = {"dot": _g["dot"], "add": _g["add"], "subtract": _g["subtract"],
             "multiply": _g["multiply"], "divide": _g["divide"]}

    def cast_storage(*a, **k):
        raise NotImplementedError(
            "symbolic cast_storage: sparse storage conversion is eager-only "
            "(nd.sparse.cast_storage)")
    table["cast_storage"] = cast_storage
    return _SymNS("sparse", table)


linalg = _sym_linalg_ns()
random = _sym_random_ns()
sparse = _sym_sparse_ns()
__all__ += ["linalg", "random", "sparse", "BatchNorm_v1", "CuDNNBatchNorm",
            "Convolution_v1", "Pooling_v1"]
__all__ = list(dict.fromkeys(__all__))
