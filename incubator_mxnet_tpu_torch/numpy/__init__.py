"""``mx.np``: the NumPy-semantics array namespace (counterpart of
``incubator_mxnet_tpu/numpy/__init__.py``; MXNet's ``python/mxnet/numpy``).

``ndarray`` is an ``NDArray`` whose operators follow NumPy: comparisons
give bool masks (``mx.nd`` gives the input's type), ``x == None`` is
falsy, reductions take NumPy's ``axis``/``keepdims`` and ``std``/``var``
are the population moments. Each function runs torch on the array's
device through the ``nd`` choke point ``_apply``, so it records for
``autograd`` inside ``record()``; the results are re-classed in place
(``_apply_np``), which keeps the object autograd recorded.

Types follow the JAX package, which runs JAX without x64: Python lists
and numbers become float32, and a result that torch makes int64, float64
or complex128 comes back int32, float32 or complex64 (``_narrow``).
Functions whose result shape depends on the data (``unique``,
``insert``, the set operations) and the general eigen-solvers compute on
the host with NumPy and return on the array's device, as the reference
does; like the reference's, those are not on the tape.
"""
from __future__ import annotations

import builtins
import math

import numpy as onp
import torch
import torch.nn.functional as F

from ..context import as_device
from ..ndarray import NDArray
from ..ndarray import ndarray as _nd_mod
from ..ndarray.ndarray import torch_dtype

__all__ = ["ndarray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "logspace", "eye", "identity", "meshgrid",
           "concatenate",
           "stack", "vstack", "hstack", "dstack", "split", "expand_dims",
           "squeeze", "transpose", "swapaxes", "moveaxis", "reshape", "where",
           "einsum", "dot", "matmul", "tensordot", "inner", "outer", "kron",
           "trace", "diag", "tril", "triu", "cross", "clip", "unique", "sort",
           "argsort", "argmax", "argmin", "take", "repeat", "tile", "flip",
           "roll", "pad", "nonzero", "count_nonzero", "copysign", "isnan",
           "isinf", "isfinite", "random", "linalg"]

#: JAX without x64: what each wide torch type becomes
_NARROW = {torch.int64: torch.int32, torch.float64: torch.float32,
           torch.complex128: torch.complex64}


def _narrow(t):
    if isinstance(t, torch.Tensor):
        nt = _NARROW.get(t.dtype)
        return t if nt is None else t.to(nt)
    if isinstance(t, (list, tuple)):
        return type(t)(_narrow(x) for x in t)
    return t


def _np_dtype(dtype):
    """The torch type of a NumPy-style dtype, as JAX without x64 makes it."""
    t = torch_dtype(dtype)
    return _NARROW.get(t, t)


class ndarray(NDArray):
    """NumPy-semantics array (MXNet's ``numpy/multiarray.py`` ndarray)."""

    __slots__ = ()  # layout-compatible with NDArray for in-place re-classing

    def __getitem__(self, key):
        key = _nd_mod._index_key(key)
        return _apply_np(lambda x: x[key], self)

    def _reduce(self, fn, axis=None, keepdims=False):
        return _apply_np(lambda x: fn(x, _axes(axis, x), keepdims), self)

    def mean(self, axis=None, dtype=None, keepdims=False, **kw):
        return self._reduce(_mean, axis, keepdims)

    def std(self, axis=None, keepdims=False, **kw):
        return self._reduce(_std, axis, keepdims)

    def var(self, axis=None, keepdims=False, **kw):
        return self._reduce(_var, axis, keepdims)

    def reshape(self, *shape, **kw):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return _apply_np(lambda x: x.reshape(shape), self)

    def flatten(self, order="C"):
        return _apply_np(lambda x: x.reshape(-1), self)

    def item(self):
        return self.asnumpy().item()

    def tolist(self):
        return self.asnumpy().tolist()

    def astype(self, dtype, copy=True):
        dt = _np_dtype(dtype)
        return _apply_np(lambda x: x.to(dt, copy=True), self)

    def copy(self):
        # through _apply so the autograd tape links the copy to its source
        return _apply_np(torch.clone, self)

    def as_nd_ndarray(self):
        """A classic NDArray that stays on the tape (an identity op)."""
        out = _nd_mod._apply(lambda x: x, self)
        out.__class__ = NDArray
        return out

    @property
    def T(self):
        return _apply_np(lambda x: x.permute(*reversed(range(x.dim()))), self)

    # numpy semantics: comparisons yield BOOL masks (mx.nd yields the
    # input's type), so `a[a > 0]` boolean-indexes
    def _cmp(self, other, fn):
        o = other._data if isinstance(other, NDArray) else other
        if isinstance(o, (list, tuple, onp.ndarray, onp.generic)):
            o = _host(o)
        return _apply_np(lambda x: _scalar_op(fn)(x, o), self)

    def __gt__(self, other):
        return self._cmp(other, torch.gt)

    def __ge__(self, other):
        return self._cmp(other, torch.ge)

    def __lt__(self, other):
        return self._cmp(other, torch.lt)

    def __le__(self, other):
        return self._cmp(other, torch.le)

    def __eq__(self, other):
        if not isinstance(other, (NDArray, int, float, builtins.bool,
                                  complex, onp.ndarray, onp.generic, list,
                                  tuple)):
            return False  # numpy parity: `x == None` is falsy, not an error
        return self._cmp(other, torch.eq)

    def __ne__(self, other):
        if not isinstance(other, (NDArray, int, float, builtins.bool,
                                  complex, onp.ndarray, onp.generic, list,
                                  tuple)):
            return True
        return self._cmp(other, torch.ne)

    __hash__ = NDArray.__hash__


def _apply_np(fn, *inputs):
    """``_apply`` giving ``mx.np.ndarray`` outputs in JAX's types (int64 →
    int32, float64 → float32). The NDArray ``_apply`` returns is re-classed
    in place, so autograd keeps the object it recorded."""
    out = _nd_mod._apply(lambda *xs: _narrow(fn(*xs)), *inputs)
    if isinstance(out, (list, tuple)):
        for o in out:
            o.__class__ = ndarray
        return out
    out.__class__ = ndarray
    return out


def _out(t):
    """A tensor (or a tuple/list of them) as untaped ``ndarray``s."""
    if isinstance(t, (list, tuple)):
        return type(t)(_out(x) for x in t)
    return ndarray(_narrow(t))


def _host(x, dtype=None):
    """A CPU tensor from numpy data, a list or a number, by the JAX
    package's rules (Python lists and float64 → float32)."""
    if isinstance(x, (list, tuple, int, float)) and dtype is None:
        return torch.tensor(onp.asarray(x, onp.float32))
    a = onp.asarray(x, dtype=None if dtype is None else dtype)
    if a.dtype.kind in "biufc":
        return _narrow(torch.from_numpy(onp.array(a, copy=True)))
    raise TypeError("mx.np cannot hold %r" % (a.dtype,))


def _to(x):
    if isinstance(x, NDArray):
        return x
    return array(x)


def _t(x, device=None):
    """``x`` as a tensor: an NDArray's own, else a new one on ``device``."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, torch.Tensor):
        return x
    return _host(x).to(device if device is not None else as_device(None))


def _scalar_op(fn):
    """A binary tensor function that also takes a Python number (or a
    CPU tensor from a list) on either side; a number keeps the tensor's
    type within its kind, as JAX's weak types do."""
    def op(a, b):
        if not isinstance(a, torch.Tensor):
            a = _nd_mod._as_tensor(a, b)
        elif not isinstance(b, torch.Tensor):
            b = _nd_mod._as_tensor(b, a)
        if a.device != b.device:
            if a.dim() == 0 and a.device.type == "cpu":
                a = a.to(b.device)
            else:
                b = b.to(a.device)
        return fn(a, b)
    return op


def _floating(x):
    """``x`` in float32 unless it is already a floating type (NumPy's
    float results of integer inputs, as JAX computes them)."""
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


def _axes(axis, x):
    """NumPy's ``axis`` as a tuple of non-negative dims (None: all)."""
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, (list, tuple)):
        return tuple(a % builtins.max(x.dim(), 1) for a in axis)
    return (axis % builtins.max(x.dim(), 1),)


def _keep(out, x, axes, keepdims):
    if keepdims:
        for a in sorted(axes):
            out = out.unsqueeze(a)
    return out


# ------------------------------------------------------------ reductions
def _sum(x, axes, keepdims):
    if not axes:
        return x.clone() if x.dtype != torch.bool else x.to(torch.int32)
    return torch.sum(x, dim=axes, keepdim=keepdims)


def _prod(x, axes, keepdims):
    out = x.to(torch.int32) if x.dtype == torch.bool else x
    for a in sorted(axes, reverse=True):
        out = torch.prod(out, dim=a, keepdim=keepdims)
    return out


def _mean(x, axes, keepdims):
    x = _floating(x)
    if not axes:
        return x.clone()
    return torch.mean(x, dim=axes, keepdim=keepdims)


def _var(x, axes, keepdims):
    x = _floating(x)
    return torch.var(x, dim=axes, correction=0, keepdim=keepdims)


def _std(x, axes, keepdims):
    x = _floating(x)
    return torch.std(x, dim=axes, correction=0, keepdim=keepdims)


def _amax(x, axes, keepdims):
    if not axes:
        return x.clone()
    return torch.amax(x, dim=axes, keepdim=keepdims)


def _amin(x, axes, keepdims):
    if not axes:
        return x.clone()
    return torch.amin(x, dim=axes, keepdim=keepdims)


def _nansum(x, axes, keepdims):
    if not x.is_floating_point():
        return _sum(x, axes, keepdims)
    return torch.nansum(x, dim=axes, keepdim=keepdims)


def _nanprod(x, axes, keepdims):
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.ones_like(x), x)
    return _prod(x, axes, keepdims)


def _nanmax(x, axes, keepdims):
    if x.is_floating_point():
        nan = torch.isnan(x)
        out = _amax(torch.where(nan, torch.full_like(x, -math.inf), x), axes,
                    keepdims)
        return torch.where(_all(nan, axes, keepdims),
                           torch.full_like(out, math.nan), out)
    return _amax(x, axes, keepdims)


def _nanmin(x, axes, keepdims):
    if x.is_floating_point():
        nan = torch.isnan(x)
        out = _amin(torch.where(nan, torch.full_like(x, math.inf), x), axes,
                    keepdims)
        return torch.where(_all(nan, axes, keepdims),
                           torch.full_like(out, math.nan), out)
    return _amin(x, axes, keepdims)


def _moved(x, axes):
    """``x`` with ``axes`` moved last and merged into one."""
    rest = [d for d in range(x.dim()) if d not in axes]
    y = x.permute(*rest, *axes)
    return y.reshape(*[x.shape[d] for d in rest], -1)


def _quantile_along(x, q, axes, keepdims, method, nan=False):
    """NumPy's quantile(s) ``q`` (a float or a 1-D tensor) of ``x`` over
    ``axes``: torch's ``quantile`` over the merged axes (its methods are
    NumPy's names)."""
    x = _floating(x)
    y = _moved(x, axes)
    qt = q if isinstance(q, torch.Tensor) else torch.tensor(
        q, dtype=x.dtype, device=x.device)
    fn = torch.nanquantile if nan else torch.quantile
    out = fn(y, qt.to(x.dtype), dim=-1, interpolation=method)
    if keepdims:
        lead = 1 if qt.dim() else 0
        for a in sorted(axes):
            out = out.unsqueeze(a + lead)
    return out


def _median(x, axes, keepdims):
    return _quantile_along(x, 0.5, axes, keepdims, "midpoint")


def _all(x, axes, keepdims):
    if not axes:
        return x.to(torch.bool)
    return torch.all(x, dim=axes, keepdim=keepdims)


def _any(x, axes, keepdims):
    if not axes:
        return x.to(torch.bool)
    return torch.any(x, dim=axes, keepdim=keepdims)


# ------------------------------------------------------------ creation
def array(object, dtype=None, ctx=None):
    if isinstance(object, NDArray):
        data = object._data.detach().clone()
        if dtype is not None:
            data = data.to(_np_dtype(dtype))
        if ctx is not None:
            data = data.to(as_device(ctx))
        return ndarray(data)
    if dtype is None and isinstance(object, (list, tuple, int, float)):
        # MXNet deepnumpy semantics: python containers default to float32
        t = torch.tensor(onp.asarray(object, dtype=onp.float32))
    else:
        a = onp.asarray(object)
        t = _host(a) if dtype is None else \
            torch.from_numpy(onp.array(a, copy=True)).to(_np_dtype(dtype))
    return ndarray(t.to(as_device(ctx)))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, dtype="float32", ctx=None, **kw):
    return ndarray(torch.zeros(_shape(shape), dtype=_np_dtype(dtype),
                               device=as_device(ctx)))


def ones(shape, dtype="float32", ctx=None, **kw):
    return ndarray(torch.ones(_shape(shape), dtype=_np_dtype(dtype),
                              device=as_device(ctx)))


def full(shape, fill_value, dtype="float32", ctx=None, **kw):
    return ndarray(torch.full(_shape(shape), fill_value,
                              dtype=_np_dtype(dtype), device=as_device(ctx)))


def empty(shape, dtype="float32", ctx=None):
    return zeros(shape, dtype, ctx)


def arange(start, stop=None, step=1, dtype=None, ctx=None):
    if stop is None:
        start, stop = 0, start
    t = torch.arange(start, stop, step, device=as_device(ctx))
    return ndarray(t.to(_np_dtype(dtype)) if dtype else _narrow(t))


def _linspace(start, stop, num, endpoint, device):
    """NumPy's linspace in float32 (step = (stop - start) / div)."""
    div = (num - 1) if endpoint else num
    i = torch.arange(num, dtype=torch.float32, device=device)
    if num == 1 or div == 0:
        return torch.full((num,), float(start), device=device)
    step = (stop - start) / div
    out = start + i * step
    if endpoint and num > 1:
        out[-1] = stop
    return out


def linspace(start, stop, num=50, endpoint=True, dtype=None, ctx=None, **kw):
    t = _linspace(start, stop, num, endpoint, as_device(ctx))
    return ndarray(t.to(_np_dtype(dtype)) if dtype else t)


def logspace(start, stop, num=50, endpoint=True, base=10.0, dtype=None,
             ctx=None):
    t = _linspace(start, stop, num, endpoint, as_device(ctx))
    return ndarray(torch.pow(torch.tensor(float(base), device=t.device), t))


def eye(N, M=None, k=0, dtype="float32", ctx=None):
    device = as_device(ctx)
    M = N if M is None else M
    rows = torch.arange(N, device=device).unsqueeze(1)
    cols = torch.arange(M, device=device).unsqueeze(0)
    return ndarray((cols - rows == k).to(_np_dtype(dtype)))


def identity(n, dtype="float32", ctx=None):
    return eye(n, dtype=dtype, ctx=ctx)


def meshgrid(*xi, indexing="xy"):
    outs = torch.meshgrid(*[_to(x)._data for x in xi], indexing=indexing)
    return [ndarray(o.clone()) for o in outs]


# ------------------------------------------------------------ generated ops
def _cbrt(x):
    x = _floating(x)
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def _reciprocal(x):
    return torch.reciprocal(x) if x.is_floating_point() else \
        torch.div(1, x, rounding_mode="trunc").to(x.dtype)


def _sort_last(x):
    return torch.sort(x, dim=-1, stable=True).values


def _float_unary(fn):
    return lambda x: fn(_floating(x))


_UNARY_FNS = {
    "abs": torch.abs, "absolute": torch.abs, "sign": torch.sign,
    "rint": torch.round, "ceil": torch.ceil, "floor": torch.floor,
    "trunc": torch.trunc, "sqrt": _float_unary(torch.sqrt), "cbrt": _cbrt,
    "square": torch.square, "exp": _float_unary(torch.exp),
    "expm1": _float_unary(torch.expm1), "log": _float_unary(torch.log),
    "log2": _float_unary(torch.log2), "log10": _float_unary(torch.log10),
    "log1p": _float_unary(torch.log1p), "sin": _float_unary(torch.sin),
    "cos": _float_unary(torch.cos), "tan": _float_unary(torch.tan),
    "arcsin": _float_unary(torch.asin), "arccos": _float_unary(torch.acos),
    "arctan": _float_unary(torch.atan), "sinh": _float_unary(torch.sinh),
    "cosh": _float_unary(torch.cosh), "tanh": _float_unary(torch.tanh),
    "arcsinh": _float_unary(torch.asinh),
    "arccosh": _float_unary(torch.acosh),
    "arctanh": _float_unary(torch.atanh),
    "degrees": _float_unary(torch.rad2deg),
    "radians": _float_unary(torch.deg2rad), "reciprocal": _reciprocal,
    "negative": torch.neg, "isnan": torch.isnan, "isinf": torch.isinf,
    "isfinite": torch.isfinite, "sort": _sort_last,
    "nonzero": lambda x: torch.nonzero(x, as_tuple=True)}
_UNARY_NP = list(_UNARY_FNS)


def _true_divide(a, b):
    return torch.true_divide(a, b)


def _int_ok(fn):
    """``fn`` on integer inputs through float32 where torch has no integer
    kernel (``hypot``, ``arctan2``, ``copysign``: NumPy's float results)."""
    return lambda a, b: fn(_floating(a), _floating(b))


def _float_power(a, b):
    return torch.float_power(a, b)


_BINARY_FNS = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": _true_divide, "true_divide": _true_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "power": torch.pow, "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": _int_ok(torch.hypot), "arctan2": _int_ok(torch.atan2),
    "copysign": _int_ok(torch.copysign), "equal": torch.eq,
    "not_equal": torch.ne, "less": torch.lt, "less_equal": torch.le,
    "greater": torch.gt, "greater_equal": torch.ge,
    "logical_and": torch.logical_and, "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor, "float_power": _float_power,
    "fmod": torch.fmod, "gcd": torch.gcd, "lcm": torch.lcm}
_BINARY_NP = list(_BINARY_FNS)

_REDUCE_FNS = {
    "sum": _sum, "prod": _prod, "mean": _mean, "std": _std, "var": _var,
    "max": _amax, "min": _amin, "amax": _amax, "amin": _amin,
    "nansum": _nansum, "nanprod": _nanprod, "nanmax": _nanmax,
    "nanmin": _nanmin, "median": _median, "all": _all, "any": _any}
_REDUCE_NP = list(_REDUCE_FNS)

_g = globals()
for _name in _UNARY_NP:
    def _mk(fn, name):
        def op(x, out=None, **kw):
            return _apply_np(fn, _to(x))
        op.__name__ = name
        return op
    _g[_name] = _mk(_UNARY_FNS[_name], _name)
    if _name not in __all__:
        __all__.append(_name)


def _binary_np(fn, x1, x2):
    """``fn`` on two operands, either an NDArray or a Python number (kept
    weakly typed, as JAX keeps it)."""
    sfn = _scalar_op(fn)
    scalar = (int, float, builtins.bool)
    if isinstance(x1, NDArray) and isinstance(x2, NDArray):
        return _apply_np(sfn, x1, x2)
    if isinstance(x1, NDArray) and isinstance(x2, scalar):
        return _apply_np(lambda a: sfn(a, x2), x1)
    if isinstance(x2, NDArray) and isinstance(x1, scalar):
        return _apply_np(lambda b: sfn(x1, b), x2)
    if isinstance(x1, NDArray):
        return _apply_np(sfn, x1, _to(x2).as_in_context(x1.context))
    if isinstance(x2, NDArray):
        return _apply_np(sfn, _to(x1).as_in_context(x2.context), x2)
    return _apply_np(sfn, _to(x1), _to(x2))


for _name in _BINARY_NP:
    def _mkb(fn, name):
        def op(x1, x2, out=None, **kw):
            return _binary_np(fn, x1, x2)
        op.__name__ = name
        return op
    _g[_name] = _mkb(_BINARY_FNS[_name], _name)
    if _name not in __all__:
        __all__.append(_name)

for _name in _REDUCE_NP:
    def _mkr(fn, name):
        def op(a, axis=None, keepdims=False, out=None, **kw):
            return _apply_np(lambda x: fn(x, _axes(axis, x), keepdims),
                             _to(a))
        op.__name__ = name
        return op
    _g[_name] = _mkr(_REDUCE_FNS[_name], _name)
    if _name not in __all__:
        __all__.append(_name)


# ------------------------------------------------------------ shape/linalg ops
def _same_device(xs):
    dev = xs[0].device
    return [x if x.device == dev else x.to(dev) for x in xs]


def concatenate(seq, axis=0, out=None):
    if axis is None:
        return _apply_np(lambda *xs: torch.cat(
            [x.reshape(-1) for x in _same_device(xs)]), *[_to(s) for s in seq])
    return _apply_np(lambda *xs: torch.cat(_same_device(xs), dim=axis),
                     *[_to(s) for s in seq])


def stack(arrays, axis=0, out=None):
    return _apply_np(lambda *xs: torch.stack(_same_device(xs), dim=axis),
                     *[_to(a) for a in arrays])


def vstack(tup):
    return _apply_np(lambda *xs: torch.vstack(_same_device(xs)),
                     *[_to(a) for a in tup])


def hstack(tup):
    return _apply_np(lambda *xs: torch.hstack(_same_device(xs)),
                     *[_to(a) for a in tup])


def dstack(tup):
    return _apply_np(lambda *xs: torch.dstack(_same_device(xs)),
                     *[_to(a) for a in tup])


def _split_arg(ind):
    if isinstance(ind, NDArray):
        ind = ind.asnumpy().tolist()
    if isinstance(ind, (list, tuple, onp.ndarray)):
        return [int(i) for i in ind]
    return int(ind)


def split(ary, indices_or_sections, axis=0):
    ind = _split_arg(indices_or_sections)
    x = _to(ary)
    if isinstance(ind, int) and x.shape[axis] % ind:
        raise ValueError("array split does not result in an equal division")
    return list(_apply_np(lambda t: torch.tensor_split(t, ind, dim=axis), x))


def _expand(x, axis):
    axes = axis if isinstance(axis, (tuple, list)) else (axis,)
    n = x.dim() + len(axes)
    for a in sorted(a % n for a in axes):
        x = x.unsqueeze(a)
    return x


def expand_dims(a, axis):
    return _apply_np(lambda x: _expand(x, axis), _to(a))


def squeeze(a, axis=None):
    def fn(x):
        if axis is None:
            return x.squeeze()
        axes = axis if isinstance(axis, (tuple, list)) else (axis,)
        for d in axes:
            if x.shape[d] != 1:
                raise ValueError("cannot select an axis to squeeze out "
                                 "which has size not equal to one")
        return x.squeeze(tuple(axes))
    return _apply_np(fn, _to(a))


def _perm(x, axes):
    return x.permute(*(reversed(range(x.dim())) if axes is None else axes))


def transpose(a, axes=None):
    return _apply_np(lambda x: _perm(x, axes), _to(a))


def swapaxes(a, axis1, axis2):
    return _apply_np(lambda x: torch.swapaxes(x, axis1, axis2), _to(a))


def moveaxis(a, source, destination):
    return _apply_np(lambda x: torch.movedim(x, source, destination), _to(a))


def reshape(a, newshape, order="C"):
    return _apply_np(lambda x: torch.reshape(x, _shape(newshape)), _to(a))


def _where3(c, a, b):
    return torch.where(c.to(torch.bool), a, b)


def where(condition, x=None, y=None):
    if x is None:
        c = _to(condition)._data
        return tuple(_out(o) for o in torch.nonzero(c, as_tuple=True))
    c = _to(condition)
    return _apply_np(lambda c_, a, b: _where3(c_, *_promote(a, b)), c,
                     _to(x).as_in_context(c.context),
                     _to(y).as_in_context(c.context))


def _promote(*xs):
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    return [x.to(dt) for x in xs]


def einsum(subscripts, *operands, **kw):
    """MXNet's ``np_einsum_op``: ``torch.einsum`` (cuBLAS on the card)."""
    return _apply_np(lambda *xs: torch.einsum(subscripts, *_promote(*xs)),
                     *[_to(o) for o in operands])


def _dot(a, b):
    if a.dim() == 0 or b.dim() == 0:
        return a * b
    if b.dim() == 1 or a.dim() == 1 or (a.dim() == 2 and b.dim() == 2):
        return torch.matmul(*_promote(a, b))
    return torch.tensordot(*_promote(a, b), dims=([-1], [-2]))


def dot(a, b, out=None):
    return _apply_np(_dot, _to(a), _to(b))


def matmul(a, b, out=None):
    return _apply_np(lambda x, y: torch.matmul(*_promote(x, y)), _to(a),
                     _to(b))


def tensordot(a, b, axes=2):
    return _apply_np(lambda x, y: torch.tensordot(*_promote(x, y), dims=axes),
                     _to(a), _to(b))


def inner(a, b):
    return _apply_np(lambda x, y: torch.inner(*_promote(x, y)), _to(a),
                     _to(b))


def outer(a, b):
    return _apply_np(lambda x, y: torch.outer(*_promote(x.reshape(-1),
                                                        y.reshape(-1))),
                     _to(a), _to(b))


def kron(a, b):
    return _apply_np(lambda x, y: torch.kron(*_promote(x, y)), _to(a), _to(b))


def trace(a, offset=0, axis1=0, axis2=1):
    return _apply_np(lambda x: torch.diagonal(x, offset, axis1, axis2)
                     .sum(-1), _to(a))


def diag(v, k=0):
    return _apply_np(lambda x: torch.diag(x, k), _to(v))


def tril(m, k=0):
    return _apply_np(lambda x: torch.tril(x, k), _to(m))


def triu(m, k=0):
    return _apply_np(lambda x: torch.triu(x, k), _to(m))


def cross(a, b, axis=-1):
    return _apply_np(lambda x, y: torch.linalg.cross(*_promote(x, y),
                                                     dim=axis),
                     _to(a), _to(b))


def _bound(v, x):
    if isinstance(v, NDArray):
        return v._data.to(x.device)
    return v


def clip(a, a_min, a_max, out=None):
    return _apply_np(lambda x: torch.clamp(x, _bound(a_min, x),
                                           _bound(a_max, x)), _to(a))


def unique(ar, return_index=False, return_inverse=False, return_counts=False,
           axis=None):
    x = _to(ar)
    res = onp.unique(x.asnumpy(), return_index=return_index,
                     return_inverse=return_inverse,
                     return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return tuple(array(r, ctx=x.context) for r in res)
    return array(res, ctx=x.context)


def argsort(a, axis=-1, kind=None, order=None):
    def fn(x):
        if axis is None:
            return torch.argsort(x.reshape(-1), stable=True)
        return torch.argsort(x, dim=axis, stable=True)
    return _apply_np(fn, _to(a))


def _argreduce(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1), 0)
        return out.reshape((1,) * x.dim()) if keepdims else out
    return fn(x, axis, keepdim=keepdims)


def argmax(a, axis=None, out=None, keepdims=False):
    return _apply_np(lambda x: _argreduce(torch.argmax, x, axis, keepdims),
                     _to(a))


def argmin(a, axis=None, out=None, keepdims=False):
    return _apply_np(lambda x: _argreduce(torch.argmin, x, axis, keepdims),
                     _to(a))


def _take(x, i, axis):
    """``jnp.take``'s default "fill" mode: negative ids count from the end,
    ids out of range give NaN (the type's minimum for integers); the
    gather itself is clamped, so no id reads out of bounds on the card."""
    if axis is None:
        x, axis = x.reshape(-1), 0
    axis %= x.dim()
    n = x.shape[axis]
    i = i.to(torch.int64).to(x.device)
    i = torch.where(i < 0, i + n, i)
    ok = (i >= 0) & (i < n)
    flat = torch.index_select(x, axis, i.clamp(0, builtins.max(n - 1, 0))
                              .reshape(-1))
    out = flat.reshape(x.shape[:axis] + i.shape + x.shape[axis + 1:])
    if builtins.bool(ok.all()):
        return out
    fill = math.nan if x.is_floating_point() else torch.iinfo(x.dtype).min
    okb = ok.reshape((1,) * axis + i.shape + (1,) * (x.dim() - axis - 1))
    return torch.where(okb, out, torch.full_like(out, fill))


def take(a, indices, axis=None, mode=None, out=None):
    x = _to(a)
    return _apply_np(lambda t, i: _take(t, i, axis), x,
                     _to(indices).as_in_context(x.context))


def repeat(a, repeats, axis=None):
    def fn(x):
        if axis is None:
            return torch.repeat_interleave(x.reshape(-1), repeats)
        return torch.repeat_interleave(x, repeats, dim=axis)
    return _apply_np(fn, _to(a))


def tile(A, reps):
    return _apply_np(lambda x: torch.tile(x, _shape(reps)), _to(A))


def flip(m, axis=None):
    def fn(x):
        dims = tuple(range(x.dim())) if axis is None else _shape(axis)
        return torch.flip(x, dims)
    return _apply_np(fn, _to(m))


def roll(a, shift, axis=None):
    return _apply_np(lambda x: torch.roll(x, shift, axis), _to(a))


def _pad_index(n, before, after, mode, device):
    """The source index of each position of an axis of length ``n``
    padded by (before, after) in NumPy's mode."""
    i = torch.arange(-before, n + after, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        p = 2 * (n - 1)
        j = i % p
        return torch.where(j >= n, p - j, j)
    if mode == "symmetric":
        p = 2 * n
        j = i % p
        return torch.where(j >= n, p - 1 - j, j)
    raise NotImplementedError("pad mode %r" % mode)


def _pad_widths(pad_width, ndim):
    pw = onp.broadcast_to(onp.asarray(pad_width, dtype=onp.int64),
                          (ndim, 2))
    return [(int(b), int(a)) for b, a in pw]


def pad(array_, pad_width, mode="constant", **kw):
    def fn(x):
        widths = _pad_widths(pad_width, x.dim())
        if mode == "constant":
            cv = kw.get("constant_values", 0)
            flat = [w for b, a in reversed(widths) for w in (b, a)]
            return F.pad(x, flat, value=float(onp.asarray(cv)))
        for d, (b, a) in enumerate(widths):
            if b or a:
                x = torch.index_select(x, d, _pad_index(x.shape[d], b, a,
                                                        mode, x.device))
        return x
    return _apply_np(fn, _to(array_))


def count_nonzero(a, axis=None):
    return _apply_np(lambda x: torch.count_nonzero(x, dim=axis), _to(a))


def zeros_like(a, dtype=None):
    return _apply_np(lambda x: torch.zeros_like(
        x, dtype=_np_dtype(dtype) if dtype else None), _to(a))


def ones_like(a, dtype=None):
    return _apply_np(lambda x: torch.ones_like(
        x, dtype=_np_dtype(dtype) if dtype else None), _to(a))


def full_like(a, fill_value, dtype=None):
    return _apply_np(lambda x: torch.full_like(x, fill_value), _to(a))


__all__ += ["zeros_like", "ones_like", "full_like"]


# ------------------------------------------------------------ submodules
def _size(size):
    if size is None:
        return ()
    return tuple(size) if isinstance(size, (tuple, list)) else (size,)


class _NPRandom:
    """``mx.np.random`` (MXNet's ``python/mxnet/numpy/random.py``). Draws
    come from the port's seedable generator of the current context's
    device (``ndarray/random.py``): one ``seed`` repeats them, and they
    follow the reference's distributions, not its values."""

    @staticmethod
    def _gen(device):
        from ..ndarray.random import _generator
        return _generator(device)

    def _uniform_t(self, shape, device, dtype=torch.float32):
        return torch.rand(shape, dtype=dtype, device=device,
                          generator=self._gen(device))

    def _normal_t(self, shape, device, dtype=torch.float32):
        return torch.randn(shape, dtype=dtype, device=device,
                           generator=self._gen(device))

    def _gamma_t(self, alpha, shape, device):
        a = torch.as_tensor(alpha, dtype=torch.float32, device=device)
        a = a.expand(shape) if shape else a
        return torch._standard_gamma(a.contiguous(),
                                     generator=self._gen(device))

    def seed(self, s):
        from ..ndarray import random as _r
        _r.seed(s)

    def uniform(self, low=0.0, high=1.0, size=None, dtype=None, ctx=None):
        dev = as_device(ctx)
        u = self._uniform_t(_size(size), dev, _np_dtype(dtype or "float32"))
        return ndarray(low + u * (high - low))

    def normal(self, loc=0.0, scale=1.0, size=None, dtype=None, ctx=None):
        dev = as_device(ctx)
        n = self._normal_t(_size(size), dev, _np_dtype(dtype or "float32"))
        return ndarray(loc + scale * n)

    def randint(self, low, high=None, size=None, dtype="int64", ctx=None):
        if high is None:
            low, high = 0, low
        dev = as_device(ctx)
        return ndarray(torch.randint(int(low), int(high), _size(size),
                                     dtype=torch.int32, device=dev,
                                     generator=self._gen(dev)))

    def rand(self, *size):
        return self.uniform(size=size or ())

    def randn(self, *size):
        return self.normal(size=size or ())

    def choice(self, a, size=None, replace=True, p=None):
        if isinstance(a, (NDArray, onp.ndarray, list)):
            arr = _to(a)._data
        else:
            arr = torch.arange(int(a), dtype=torch.int32,
                               device=as_device(None))
        dev = arr.device
        n = arr.shape[0]
        shp = _size(size)
        k = int(onp.prod(shp)) if shp else 1
        w = torch.ones(n, device=dev) if p is None else \
            _to(p)._data.to(dev).float()
        idx = torch.multinomial(w, k, replacement=replace,
                                generator=self._gen(dev))
        return ndarray(arr[idx].reshape(shp + tuple(arr.shape[1:])))

    def shuffle(self, x):
        dev = x._data.device
        perm = torch.randperm(x.shape[0], device=dev,
                              generator=self._gen(dev))
        x._data = x._data[perm]

    _shp = staticmethod(_size)

    def beta(self, a, b, size=None):
        dev = as_device(None)
        ga = self._gamma_t(a, self._shp(size), dev)
        gb = self._gamma_t(b, self._shp(size), dev)
        return ndarray(ga / (ga + gb))

    def gamma(self, shape, scale=1.0, size=None):
        return ndarray(scale * self._gamma_t(shape, self._shp(size),
                                             as_device(None)))

    def exponential(self, scale=1.0, size=None):
        dev = as_device(None)
        e = torch.empty(self._shp(size), device=dev).exponential_(
            1.0, generator=self._gen(dev))
        return ndarray(scale * e)

    def laplace(self, loc=0.0, scale=1.0, size=None):
        u = self._uniform_t(self._shp(size), as_device(None)) - 0.5
        return ndarray(loc - scale * torch.sign(u)
                       * torch.log1p(-2.0 * torch.abs(u)))

    def logistic(self, loc=0.0, scale=1.0, size=None):
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray(loc + scale * (torch.log(u) - torch.log1p(-u)))

    def gumbel(self, loc=0.0, scale=1.0, size=None):
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray(loc - scale * torch.log(-torch.log(u)))

    def pareto(self, a, size=None):
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray(torch.exp(-torch.log1p(-u) / a) - 1.0)

    def weibull(self, a, size=None):
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray((-torch.log1p(-u)) ** (1.0 / a))

    def chisquare(self, df, size=None):
        return ndarray(2.0 * self._gamma_t(df / 2.0, self._shp(size),
                                           as_device(None)))

    def poisson(self, lam=1.0, size=None):
        dev = as_device(None)
        rates = torch.full(self._shp(size), float(lam), device=dev)
        return ndarray(torch.poisson(rates, generator=self._gen(dev))
                       .to(torch.int32))

    def multinomial(self, n, pvals, size=None):
        dev = as_device(None)
        p = torch.as_tensor(onp.asarray(pvals, onp.float32), device=dev)
        shp = self._shp(size)
        rows = int(onp.prod(shp)) if shp else 1
        draws = torch.multinomial(p.expand(rows, -1), n, replacement=True,
                                  generator=self._gen(dev))
        counts = F.one_hot(draws, len(pvals)).sum(-2).to(torch.int32)
        return ndarray(counts.reshape(shp + (len(pvals),)))

    def dirichlet(self, alpha, size=None):
        dev = as_device(None)
        al = torch.as_tensor(onp.asarray(alpha, onp.float32), device=dev)
        g = self._gamma_t(al, self._shp(size) + tuple(al.shape), dev)
        return ndarray(g / g.sum(-1, keepdim=True))

    def permutation(self, x):
        if isinstance(x, int):
            dev = as_device(None)
            return ndarray(torch.randperm(x, device=dev,
                                          generator=self._gen(dev))
                           .to(torch.int32))
        t = _to(x)._data
        perm = torch.randperm(t.shape[0], device=t.device,
                              generator=self._gen(t.device))
        return ndarray(t[perm])

    def lognormal(self, mean=0.0, sigma=1.0, size=None):
        return ndarray(torch.exp(mean + sigma * self._normal_t(
            self._shp(size), as_device(None))))

    def multivariate_normal(self, mean, cov, size=None):
        m = _to(mean)._data.float()
        c = _to(cov)._data.float().to(m.device)
        chol = torch.linalg.cholesky(c)
        z = self._normal_t(self._shp(size) + tuple(m.shape), m.device)
        return ndarray(m + z @ chol.T)

    def power(self, a, size=None):
        # inverse-CDF of p(x) = a x^(a-1) on [0, 1]
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray(u ** (1.0 / a))

    def rayleigh(self, scale=1.0, size=None):
        u = self._uniform_t(self._shp(size), as_device(None))
        return ndarray(scale * torch.sqrt(-2.0 * torch.log1p(-u)))


random = _NPRandom()


class _NPLinalg:
    """``mx.np.linalg`` (MXNet's ``python/mxnet/numpy/linalg.py``):
    ``torch.linalg`` (cuSOLVER/cuBLAS on the card, LAPACK on the CPU)."""

    def norm(self, x, ord=None, axis=None, keepdims=False):
        return _apply_np(lambda a: torch.linalg.norm(_floating(a), ord, axis,
                                                     keepdims), _to(x))

    def inv(self, a):
        return _apply_np(lambda x: torch.linalg.inv(_floating(x)), _to(a))

    def det(self, a):
        return _apply_np(lambda x: torch.linalg.det(_floating(x)), _to(a))

    def slogdet(self, a):
        s, l = torch.linalg.slogdet(_floating(_to(a)._data))
        return _out(s), _out(l)

    def cholesky(self, a):
        return _apply_np(lambda x: torch.linalg.cholesky(_floating(x)), _to(a))

    def qr(self, a):
        q, r = torch.linalg.qr(_floating(_to(a)._data))
        return _out(q), _out(r)

    def svd(self, a):
        u, s, vt = torch.linalg.svd(_floating(_to(a)._data),
                                    full_matrices=False)
        return _out(u), _out(s), _out(vt)

    def eigh(self, a):
        w, v = torch.linalg.eigh(_floating(_to(a)._data))
        return _out(w), _out(v)

    def solve(self, a, b):
        def fn(x, y):
            x = _floating(x)
            y = _floating(y)
            if y.dim() == 1:
                return torch.linalg.solve(x, y.unsqueeze(-1)).squeeze(-1)
            return torch.linalg.solve(x, y)
        return _apply_np(fn, _to(a), _to(b))

    def lstsq(self, a, b, rcond="warn"):
        """NumPy's four results (x, residuals, rank, singular values) from
        the pseudo-inverse, on every device (cuSOLVER's least squares
        gives no rank or singular values)."""
        x_ = _floating(_to(a)._data)
        y_ = _floating(_to(b)._data).to(x_.device)
        m, n = x_.shape
        s = torch.linalg.svdvals(x_)
        eps = torch.finfo(x_.dtype).eps
        tol = s.max() * builtins.max(m, n) * eps if s.numel() else 0.0
        rank = (s > tol).sum().to(torch.int32)
        sol = torch.linalg.pinv(x_, rtol=builtins.max(m, n) * eps) @ y_
        if m > n and int(rank) == n:
            r = x_ @ sol - y_
            resid = (r * r).sum(0).reshape(-1)
        else:
            resid = torch.zeros((0,), dtype=x_.dtype, device=x_.device)
        return _out(sol), _out(resid), _out(rank), _out(s)

    def pinv(self, a):
        def fn(x):
            x = _floating(x)
            m, n = x.shape[-2:]
            return torch.linalg.pinv(
                x, rtol=10.0 * builtins.max(m, n) * torch.finfo(x.dtype).eps)
        return _apply_np(fn, _to(a))

    def matrix_rank(self, a):
        return _apply_np(lambda x: torch.linalg.matrix_rank(_floating(x)),
                         _to(a))

    def eig(self, a):
        """The general eigenproblem on the host (NumPy), returned on the
        array's device, as the reference computes it."""
        x = _to(a)
        w, v = onp.linalg.eig(x.asnumpy())
        return array(w, ctx=x.context), array(v, ctx=x.context)

    def eigvals(self, a):
        x = _to(a)
        return array(onp.linalg.eigvals(x.asnumpy()), ctx=x.context)

    def eigvalsh(self, a, UPLO="L"):
        return _out(torch.linalg.eigvalsh(_floating(_to(a)._data), UPLO=UPLO))

    def tensorinv(self, a, ind=2):
        return _apply_np(
            lambda x: torch.linalg.tensorinv(_floating(x), ind=ind), _to(a))

    def tensorsolve(self, a, b, axes=None):
        return _apply_np(lambda x, y: torch.linalg.tensorsolve(
            _floating(x), _floating(y), dims=axes), _to(a), _to(b))


linalg = _NPLinalg()

pi = onp.pi
e = onp.e
inf = onp.inf
nan = onp.nan
newaxis = None
float32 = onp.float32
float64 = onp.float64
int32 = onp.int32
int64 = onp.int64
uint8 = onp.uint8
bool_ = onp.bool_


# ------------------------------------------------------------ batch 2:
# boolean masking, insert/delete, statistics, bit operations, index helpers
def _host_then(x, fn):
    """``fn`` of ``x``'s host copy (NumPy), back on ``x``'s device."""
    return array(fn(x.asnumpy()), ctx=x.context)


def insert(arr, obj, values, axis=None):
    x = _to(arr)
    o = obj.asnumpy() if isinstance(obj, NDArray) else obj
    v = values.asnumpy() if isinstance(values, NDArray) else values
    return array(onp.insert(x.asnumpy(), o, v, axis=axis).astype(
        x.asnumpy().dtype), ctx=x.context)


def delete(arr, obj, axis=None):
    x = _to(arr)
    o = _to(obj).asnumpy() if isinstance(obj, (NDArray, list, onp.ndarray)) \
        else obj
    return _host_then(x, lambda a: onp.delete(a, onp.asarray(o), axis=axis))


def append(arr, values, axis=None):
    def fn(a, v):
        a, v = _promote(a, v.to(a.device))
        if axis is None:
            return torch.cat([a.reshape(-1), v.reshape(-1)])
        return torch.cat([a, v], dim=axis)
    return _apply_np(fn, _to(arr), _to(values))


def ravel(a, order="C"):
    return _apply_np(lambda x: x.reshape(-1), _to(a))


def atleast_1d(*arys):
    out = [_apply_np(torch.atleast_1d, _to(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_2d(*arys):
    out = [_apply_np(torch.atleast_2d, _to(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def atleast_3d(*arys):
    out = [_apply_np(torch.atleast_3d, _to(a)) for a in arys]
    return out[0] if len(out) == 1 else out


def broadcast_to(array_, shape):
    return _apply_np(lambda x: torch.broadcast_to(x, _shape(shape)),
                     _to(array_))


def broadcast_arrays(*args):
    outs = torch.broadcast_tensors(*[_to(a)._data for a in args])
    return [_out(o.clone()) for o in outs]


def searchsorted(a, v, side="left", sorter=None):
    return _apply_np(lambda x, q: torch.searchsorted(
        *_promote(x, q.to(x.device).contiguous()), side=side),
        _to(a), _to(v))


def digitize(x, bins, right=False):
    side = "left" if right else "right"

    def fn(a, b):
        a, b = _promote(a, b.to(a.device))
        if b.numel() > 1 and builtins.bool(b[0] > b[-1]):  # decreasing bins
            return b.numel() - torch.searchsorted(b.flip(0), a, side=side)
        return torch.searchsorted(b, a.contiguous(), side=side)
    return _apply_np(fn, _to(x), _to(bins))


def bincount(x, weights=None, minlength=0):
    xd = _to(x)._data
    length = builtins.max(int(minlength),
                          int(xd.max()) + 1 if xd.numel() else 0)
    w = None if weights is None else _to(weights)._data.to(xd.device)
    out = torch.bincount(xd.to(torch.int64), w, minlength=length)
    return _out(out if w is not None else out.to(torch.int32))


def _hist_edges(a, bins, range_):
    if range_ is None:
        lo, hi = (float(a.min()), float(a.max())) if a.numel() else (0., 1.)
    else:
        lo, hi = float(range_[0]), float(range_[1])
    if lo == hi:
        lo, hi = lo - 0.5, hi + 0.5
    return _linspace(lo, hi, bins + 1, True, a.device).to(
        a.dtype if a.is_floating_point() else torch.float32)


def histogram(a, bins=10, range=None, weights=None, density=None):
    """NumPy's histogram on the array's device: each value's bin by
    ``searchsorted`` over the edges (the last bin closed)."""
    x = _floating(_to(a)._data).reshape(-1)
    if isinstance(bins, int):
        edges = _hist_edges(x, bins, range)
    else:
        edges = _floating(_t(bins, x.device)).reshape(-1)
    nb = edges.numel() - 1
    idx = torch.searchsorted(edges, x.contiguous(), side="right") - 1
    idx = torch.where(x == edges[-1], torch.full_like(idx, nb - 1), idx)
    ok = (idx >= 0) & (idx < nb)
    w = torch.ones_like(x) if weights is None else \
        _to(weights)._data.to(x.device).reshape(-1).to(x.dtype)
    counts = torch.zeros(nb, dtype=x.dtype, device=x.device).index_add_(
        0, idx.clamp(0, nb - 1), torch.where(ok, w, torch.zeros_like(w)))
    if density:
        counts = counts / counts.sum() / torch.diff(edges)
    return _out(counts), _out(edges)


def _flat_axis(x, axis):
    return (x.reshape(-1), 0) if axis is None else (x, axis)


def cumsum(a, axis=None, dtype=None, out=None):
    def fn(x):
        x, ax = _flat_axis(x, axis)
        out_ = torch.cumsum(x, dim=ax)
        if dtype:
            return out_.to(_np_dtype(dtype))
        return out_.to(x.dtype) if x.dtype != torch.bool else out_
    return _apply_np(fn, _to(a))


def cumprod(a, axis=None, dtype=None, out=None):
    def fn(x):
        x, ax = _flat_axis(x, axis)
        out_ = torch.cumprod(x, dim=ax)
        return out_.to(x.dtype) if x.dtype != torch.bool else out_
    return _apply_np(fn, _to(a))


def diff(a, n=1, axis=-1, prepend=None, append=None):
    return _apply_np(lambda x: torch.diff(x, n=n, dim=axis), _to(a))


def ediff1d(ary, to_end=None, to_begin=None):
    def fn(x):
        d = torch.diff(x.reshape(-1))
        parts = []
        if to_begin is not None:
            parts.append(_t(to_begin, x.device).reshape(-1).to(d.dtype))
        parts.append(d)
        if to_end is not None:
            parts.append(_t(to_end, x.device).reshape(-1).to(d.dtype))
        return torch.cat(parts)
    return _apply_np(fn, _to(ary))


def gradient(f, *varargs, axis=None, edge_order=1):
    x = _floating(_to(f)._data)
    dims = tuple(range(x.dim())) if axis is None else _shape(axis)
    kw = {"spacing": [float(v) for v in varargs]} if varargs else {}
    if kw and len(kw["spacing"]) == 1:
        kw["spacing"] = kw["spacing"] * len(dims)
    out = torch.gradient(x, dim=dims, edge_order=edge_order, **kw)
    out = [_out(o) for o in out]
    return out[0] if len(out) == 1 else out


def trapz(y, x=None, dx=1.0, axis=-1):
    yd = _floating(_to(y)._data)
    if x is None:
        return _out(torch.trapezoid(yd, dx=dx, dim=axis))
    return _out(torch.trapezoid(yd, _floating(_to(x)._data).to(yd.device),
                                dim=axis))


def _interp(x, xp, fp, left, right, period):
    x, xp, fp = _promote(_floating(x), _floating(xp.to(x.device)),
                         _floating(fp.to(x.device)))
    if period is not None:
        x = torch.remainder(x, period)
        xp = torch.remainder(xp, period)
        order = torch.argsort(xp, stable=True)
        xp, fp = xp[order], fp[order]
        xp = torch.cat([xp[-1:] - period, xp, xp[:1] + period])
        fp = torch.cat([fp[-1:], fp, fp[:1]])
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), side="right"), 1,
                    xp.numel() - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(onp.spacing(onp.finfo(onp.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, torch.ones_like(dx),
                                                     dx)) * df)
    if period is None:
        lo = fp[0] if left is None else torch.as_tensor(
            left, dtype=f.dtype, device=f.device)
        hi = fp[-1] if right is None else torch.as_tensor(
            right, dtype=f.dtype, device=f.device)
        f = torch.where(x < xp[0], lo, f)
        f = torch.where(x > xp[-1], hi, f)
    return f


def interp(x, xp, fp, left=None, right=None, period=None):
    return _apply_np(lambda a, b, c: _interp(a, b, c, left, right, period),
                     _to(x), _to(xp), _to(fp))


def _q_arg(q, x, scale=1.0):
    qt = q._data if isinstance(q, NDArray) else torch.as_tensor(
        onp.asarray(q, onp.float32))
    return qt.to(device=x.device, dtype=_floating(x).dtype) / scale


def _quantile_np(a, q, axis, method, keepdims, scale, nan=False):
    def fn(x):
        return _quantile_along(x, _q_arg(q, x, scale), _axes(axis, x),
                               keepdims, method, nan)
    return _apply_np(fn, _to(a))


def percentile(a, q, axis=None, interpolation=None, keepdims=False, **kw):
    method = interpolation or kw.get("method", "linear")
    return _quantile_np(a, q, axis, method, keepdims, 100.0)


def quantile(a, q, axis=None, interpolation=None, keepdims=False, **kw):
    method = interpolation or kw.get("method", "linear")
    return _quantile_np(a, q, axis, method, keepdims, 1.0)


def average(a, axis=None, weights=None, returned=False):
    x = _floating(_to(a)._data)
    if weights is None:
        out = _mean(x, _axes(axis, x), False)
        n = x.numel() if axis is None else x.shape[axis]
        scl = torch.tensor(float(n), device=x.device)
    else:
        w = _floating(_to(weights)._data).to(x.device)
        if axis is not None and w.dim() == 1 and x.dim() > 1:
            shp = [1] * x.dim()
            shp[axis] = -1
            w = w.reshape(shp)
        dims = _axes(axis, x)
        scl = torch.broadcast_to(w, x.shape).sum(dim=dims)
        out = (x * w).sum(dim=dims) / scl
        scl = torch.broadcast_to(scl, out.shape)
    return (_out(out), _out(scl)) if returned else _out(out)


def _cov_rows(m, y, rowvar):
    x = torch.atleast_2d(_floating(_to(m)._data))
    if not rowvar and x.shape[0] != 1:
        x = x.T
    if y is not None:
        yy = torch.atleast_2d(_floating(_to(y)._data).to(x.device))
        if not rowvar and yy.shape[0] != 1:
            yy = yy.T
        x = torch.cat([x, yy], 0)
    return x


def cov(m, y=None, rowvar=True, bias=False, ddof=None, fweights=None,
        aweights=None):
    x = _cov_rows(m, y, rowvar)
    corr = ddof if ddof is not None else (0 if bias else 1)
    return _out(torch.cov(x, correction=corr))


def corrcoef(x, y=None, rowvar=True):
    return _out(torch.corrcoef(_cov_rows(x, y, rowvar)))


def _nan_moments(x, axes, keepdims, ddof=0):
    x = _floating(x)
    ok = ~torch.isnan(x)
    n = ok.sum(dim=axes, keepdim=True).to(x.dtype)
    z = torch.where(ok, x, torch.zeros_like(x))
    mean = z.sum(dim=axes, keepdim=True) / n
    dev = torch.where(ok, x - mean, torch.zeros_like(x))
    var = (dev * dev).sum(dim=axes, keepdim=True) / (n - ddof)
    if not keepdims:
        var = var.squeeze(axes) if axes else var
    return var


def nanmean(a, axis=None, keepdims=False, **kw):
    return _apply_np(lambda x: torch.nanmean(
        _floating(x), dim=_axes(axis, x), keepdim=keepdims), _to(a))


def nanstd(a, axis=None, keepdims=False, **kw):
    return _apply_np(lambda x: torch.sqrt(_nan_moments(
        x, _axes(axis, x), keepdims)), _to(a))


def nanvar(a, axis=None, keepdims=False, **kw):
    return _apply_np(lambda x: _nan_moments(x, _axes(axis, x), keepdims),
                     _to(a))


def nan_to_num(x, copy=True, nan=0.0, posinf=None, neginf=None):
    def fn(a):
        if not a.is_floating_point():
            return a.clone()
        return torch.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)
    return _apply_np(fn, _to(x))


def around(a, decimals=0, out=None):
    def fn(x):
        if not x.is_floating_point():
            return x.clone()
        return torch.round(x, decimals=decimals)
    return _apply_np(fn, _to(a))


round = around
round_ = around


def fix(x, out=None):
    return _apply_np(lambda a: torch.fix(_floating(a)), _to(x))


def signbit(x, out=None):
    return _apply_np(torch.signbit, _to(x))


def heaviside(x1, x2, out=None):
    return _apply_np(lambda a, b: torch.heaviside(*_promote(
        _floating(a), b.to(a.device))), _to(x1), _to(x2))


def exp2(x, out=None):
    return _apply_np(lambda a: torch.exp2(_floating(a)), _to(x))


def deg2rad(x, out=None):
    return _apply_np(lambda a: torch.deg2rad(_floating(a)), _to(x))


def rad2deg(x, out=None):
    return _apply_np(lambda a: torch.rad2deg(_floating(a)), _to(x))


def logical_not(x, out=None):
    return _apply_np(torch.logical_not, _to(x))


def invert(x, out=None):
    return _apply_np(torch.bitwise_not, _to(x))


bitwise_not = invert


def _bitwise(fn):
    def op(x1, x2, out=None):
        return _binary_np(fn, x1 if isinstance(x1, (int, builtins.bool))
                          else _to(x1),
                          x2 if isinstance(x2, (int, builtins.bool))
                          else _to(x2))
    return op


bitwise_and = _bitwise(torch.bitwise_and)
bitwise_or = _bitwise(torch.bitwise_or)
bitwise_xor = _bitwise(torch.bitwise_xor)
left_shift = _bitwise(torch.bitwise_left_shift)
right_shift = _bitwise(torch.bitwise_right_shift)
for _name, _fn in (("bitwise_and", bitwise_and), ("bitwise_or", bitwise_or),
                   ("bitwise_xor", bitwise_xor), ("left_shift", left_shift),
                   ("right_shift", right_shift)):
    _fn.__name__ = _name


def floor_divide(x1, x2, out=None):
    return _binary_np(torch.floor_divide, _to(x1), _to(x2))


def flatnonzero(a):
    return _out(torch.nonzero(_to(a)._data.reshape(-1)).reshape(-1))


def argwhere(a):
    return _out(torch.argwhere(_to(a)._data))


def extract(condition, arr):
    x = _to(arr)._data
    c = _to(condition)._data.to(x.device).reshape(-1).to(torch.bool)
    return _out(x.reshape(-1)[c])


def compress(condition, a, axis=None):
    x = _to(a)._data
    if axis is None:
        x, axis = x.reshape(-1), 0
    c = _to(condition)._data.to(x.device).reshape(-1).to(torch.bool)
    c = c[:x.shape[axis]]
    return _out(torch.index_select(x, axis, torch.nonzero(c).reshape(-1)))


def resize(a, new_shape):
    x = _to(a)._data.reshape(-1)
    shp = _shape(new_shape)
    n = int(onp.prod(shp)) if shp else 1
    if x.numel() == 0:
        return _out(torch.zeros(shp, dtype=x.dtype, device=x.device))
    reps = -(-n // x.numel())
    return _out(x.repeat(reps)[:n].reshape(shp))


def rot90(m, k=1, axes=(0, 1)):
    return _apply_np(lambda x: torch.rot90(x, k, tuple(axes)), _to(m))


def fliplr(m):
    return _apply_np(torch.fliplr, _to(m))


def flipud(m):
    return _apply_np(torch.flipud, _to(m))


def array_split(ary, indices_or_sections, axis=0):
    outs = torch.tensor_split(_to(ary)._data,
                              _split_arg(indices_or_sections), dim=axis)
    return [_out(o.clone()) for o in outs]


def _nsplit(fn, ary, ind):
    return [_out(o.clone()) for o in fn(_to(ary)._data, _split_arg(ind))]


def vsplit(ary, indices_or_sections):
    return _nsplit(torch.vsplit, ary, indices_or_sections)


def hsplit(ary, indices_or_sections):
    return _nsplit(torch.hsplit, ary, indices_or_sections)


def dsplit(ary, indices_or_sections):
    return _nsplit(torch.dsplit, ary, indices_or_sections)


def column_stack(tup):
    return _apply_np(lambda *xs: torch.column_stack(_same_device(xs)),
                     *[_to(a) for a in tup])


row_stack = vstack


def tri(N, M=None, k=0, dtype="float32"):
    M = N if M is None else M
    return ndarray(torch.tril(torch.ones(N, M, device=as_device(None)), k)
                   .to(_np_dtype(dtype)))


def vander(x, N=None, increasing=False):
    return _apply_np(lambda a: torch.vander(a, N, increasing), _to(x))


def unravel_index(indices, shape, order="C"):
    outs = torch.unravel_index(_to(indices)._data.to(torch.int64),
                               _shape(shape))
    return tuple(_out(o) for o in outs)


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    """The flat index of each index tuple; each index clipped to its axis
    (or wrapped, ``mode="wrap"``), as the reference's ``jnp`` call."""
    idx = [_to(m)._data.to(torch.int64) for m in multi_index]
    out = torch.zeros_like(idx[0])
    stride = 1
    for i, d in zip(reversed(idx), reversed(tuple(dims))):
        i = i.to(out.device)
        i = torch.remainder(i, d) if mode == "wrap" else i.clamp(0, d - 1)
        out = out + i * stride
        stride *= d
    return _out(out)


def indices(dimensions, dtype="int32", sparse=False):
    dev = as_device(None)
    dt = _np_dtype(dtype)
    dims = tuple(dimensions)
    aranges = [torch.arange(d, device=dev, dtype=dt) for d in dims]
    if sparse:
        outs = []
        for k, r in enumerate(aranges):
            shp = [1] * len(dims)
            shp[k] = dims[k]
            outs.append(_out(r.reshape(shp)))
        return tuple(outs)
    if not dims:
        return _out(torch.zeros((0,), dtype=dt, device=dev))
    return _out(torch.stack(torch.meshgrid(*aranges, indexing="ij")))


def diag_indices(n, ndim=2):
    i = torch.arange(n, device=as_device(None))
    return tuple(_out(i.clone()) for _ in range(ndim))


def _tri_indices(fn, n, k, m):
    t = fn(n, n if m is None else m, k, device=as_device(None))
    return _out(t[0].clone()), _out(t[1].clone())


def tril_indices(n, k=0, m=None):
    return _tri_indices(torch.tril_indices, n, k, m)


def triu_indices(n, k=0, m=None):
    return _tri_indices(torch.triu_indices, n, k, m)


def allclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    x, y = _promote(_floating(_to(a)._data), _floating(_to(b)._data))
    return builtins.bool(torch.allclose(x, y.to(x.device), rtol, atol,
                                        equal_nan))


def isclose(a, b, rtol=1e-05, atol=1e-08, equal_nan=False):
    return _apply_np(lambda x, y: torch.isclose(
        *_promote(_floating(x), _floating(y.to(x.device))), rtol, atol,
        equal_nan), _to(a), _to(b))


def array_equal(a1, a2, equal_nan=False):
    x, y = _to(a1)._data, _to(a2)._data
    if x.shape != y.shape:
        return False
    y = y.to(x.device)
    eq = x == y
    if equal_nan and x.is_floating_point():
        eq = eq | (torch.isnan(x) & torch.isnan(y))
    return builtins.bool(eq.all())


def ptp(a, axis=None, keepdims=False):
    return _apply_np(lambda x: _amax(x, _axes(axis, x), keepdims)
                     - _amin(x, _axes(axis, x), keepdims), _to(a))


def may_share_memory(a, b, max_work=None):
    return False  # no two arrays share memory (as no two JAX arrays do)


__all__ += [
    "insert", "delete", "append", "ravel", "atleast_1d", "atleast_2d",
    "atleast_3d", "broadcast_to", "broadcast_arrays", "searchsorted",
    "digitize", "bincount", "histogram", "cumsum", "cumprod", "diff",
    "ediff1d", "gradient", "trapz", "interp", "percentile", "quantile",
    "average", "cov", "corrcoef", "nanmean", "nanstd", "nanvar",
    "nan_to_num", "around", "round", "round_", "fix", "signbit",
    "heaviside", "exp2", "deg2rad", "rad2deg", "logical_not", "invert",
    "bitwise_not", "bitwise_and", "bitwise_or", "bitwise_xor", "left_shift",
    "right_shift", "floor_divide", "flatnonzero", "argwhere", "extract",
    "compress", "resize", "rot90", "fliplr", "flipud", "array_split",
    "vsplit", "hsplit", "dsplit", "column_stack", "row_stack", "tri",
    "vander", "unravel_index", "ravel_multi_index", "indices",
    "diag_indices", "tril_indices", "triu_indices", "allclose", "isclose",
    "array_equal", "ptp", "may_share_memory",
]


# ------------------------------------------------------------ batch 3:
# window functions, nan-reductions, the rest of linalg, misc parity
def _window(fn, M, ctx):
    dev = as_device(ctx)
    if M <= 0:
        return ndarray(torch.zeros((0,), device=dev))
    if M == 1:
        return ndarray(torch.ones((1,), device=dev))
    n = torch.arange(M, dtype=torch.float32, device=dev)
    return ndarray(fn(2.0 * math.pi * n / (M - 1)))


def blackman(M, dtype=None, ctx=None):
    return _window(lambda t: 0.42 - 0.5 * torch.cos(t)
                   + 0.08 * torch.cos(2.0 * t), M, ctx)


def hamming(M, dtype=None, ctx=None):
    return _window(lambda t: 0.54 - 0.46 * torch.cos(t), M, ctx)


def hanning(M, dtype=None, ctx=None):
    return _window(lambda t: 0.5 - 0.5 * torch.cos(t), M, ctx)


def empty_like(prototype, dtype=None, order="C", ctx=None):
    # zeros, as in the reference (XLA has no uninitialised buffers)
    x = _to(prototype)._data
    return _out(torch.zeros_like(x, dtype=_np_dtype(dtype) if dtype
                                 else None))


def fabs(x):
    return _apply_np(lambda a: torch.abs(_floating(a)), _to(x))


def isneginf(x):
    return _out(torch.isneginf(_to(x)._data))


def isposinf(x):
    return _out(torch.isposinf(_to(x)._data))


def ldexp(x1, x2):
    # the exponent must be integral; the reference truncates a float one
    def fn(a, b):
        b = b.to(a.device)
        if b.is_floating_point():
            b = b.to(torch.int32)
        return torch.ldexp(_floating(a), b)
    return _apply_np(fn, _to(x1), _to(x2))


def logaddexp(x1, x2):
    return _apply_np(lambda a, b: torch.logaddexp(*_promote(
        _floating(a), _floating(b.to(a.device)))), _to(x1), _to(x2))


def _polyval(p, x):
    p, x = _promote(p, x.to(p.device))
    y = torch.zeros_like(x)
    for i in range(p.shape[0]):
        y = y * x + p[i]
    return y


def polyval(p, x):
    return _apply_np(_polyval, _to(p), _to(x))


def vdot(a, b):
    return _apply_np(lambda x, y: torch.vdot(*_promote(
        x.reshape(-1), y.to(x.device).reshape(-1))), _to(a), _to(b))


def shape(a):
    return tuple(_to(a).shape)


def shares_memory(a, b, max_work=None):
    return False  # see may_share_memory


def diag_indices_from(arr):
    x = _to(arr)
    idx = onp.diag_indices_from(onp.empty(x.shape))
    return tuple(array(i, ctx=x.context) for i in idx)


def median(a, axis=None, keepdims=False):
    return _apply_np(lambda x: _median(x, _axes(axis, x), keepdims), _to(a))


def nansum(a, axis=None, keepdims=False):
    return _apply_np(lambda x: _nansum(x, _axes(axis, x), keepdims), _to(a))


def nanmax(a, axis=None, keepdims=False):
    return _apply_np(lambda x: _nanmax(x, _axes(axis, x), keepdims), _to(a))


def nanmin(a, axis=None, keepdims=False):
    return _apply_np(lambda x: _nanmin(x, _axes(axis, x), keepdims), _to(a))


def _nanarg(fn, fill, a, axis):
    x = _to(a)._data
    if x.is_floating_point():
        x = torch.where(torch.isnan(x), torch.full_like(x, fill), x)
    return _out(_argreduce(fn, x, axis, False))


def nanargmax(a, axis=None):
    return _nanarg(torch.argmax, -math.inf, a, axis)


def nanargmin(a, axis=None):
    return _nanarg(torch.argmin, math.inf, a, axis)


def nancumsum(a, axis=None):
    def fn(x):
        if x.is_floating_point():
            x = torch.where(torch.isnan(x), torch.zeros_like(x), x)
        x, ax = _flat_axis(x, axis)
        return torch.cumsum(x, dim=ax).to(x.dtype)
    return _apply_np(fn, _to(a))


def take_along_axis(arr, indices, axis):
    idx = _to(indices)._data.to(torch.int64)

    def fn(x):
        if axis is None:
            return torch.take_along_dim(x.reshape(-1), idx.to(x.device)
                                        .reshape(-1))
        return torch.take_along_dim(x, idx.to(x.device), dim=axis)
    return _apply_np(fn, _to(arr))


def isin(element, test_elements, invert=False):
    x = _to(element)._data
    return _out(torch.isin(*_promote(x, _to(test_elements)._data
                                     .to(x.device)), invert=invert))


def in1d(ar1, ar2, invert=False):
    x = _to(ar1)._data.reshape(-1)
    return _out(torch.isin(*_promote(x, _to(ar2)._data.to(x.device)),
                           invert=invert))


def _set_op(fn, ar1, ar2):
    # the result's shape depends on the data: computed on the host, as the
    # reference's CPU kernels do
    x = _to(ar1)
    return array(fn(x.asnumpy(), _to(ar2).asnumpy()), ctx=x.context)


def union1d(ar1, ar2):
    return _set_op(onp.union1d, ar1, ar2)


def intersect1d(ar1, ar2):
    return _set_op(onp.intersect1d, ar1, ar2)


def setdiff1d(ar1, ar2):
    return _set_op(onp.setdiff1d, ar1, ar2)


def real(x):
    return _apply_np(lambda a: torch.real(a).clone() if a.is_complex()
                     else a.clone(), _to(x))


def imag(x):
    return _apply_np(lambda a: torch.imag(a).clone() if a.is_complex()
                     else torch.zeros_like(a), _to(x))


def conj(x):
    return _apply_np(lambda a: torch.conj_physical(a), _to(x))


def positive(x):
    return _apply_np(torch.clone, _to(x))


def float_power(x1, x2):
    return _binary_np(_float_power, _to(x1), _to(x2))


def fmod(x1, x2):
    return _binary_np(torch.fmod, _to(x1), _to(x2))


def divmod(x1, x2):  # noqa: A001
    q = _binary_np(torch.floor_divide, _to(x1), _to(x2))
    r = _binary_np(torch.remainder, _to(x1), _to(x2))
    return q, r


def gcd(x1, x2):
    x = _to(x1)._data
    return _out(torch.gcd(x, _to(x2)._data.to(x.device)))


def lcm(x1, x2):
    x = _to(x1)._data
    return _out(torch.lcm(x, _to(x2)._data.to(x.device)))


def rollaxis(a, axis, start=0):
    def fn(x):
        n = x.dim()
        ax = axis % n
        st = start + n if start < 0 else start
        if ax < st:
            st -= 1
        if ax == st:
            return x.clone()
        return torch.movedim(x, ax, st)
    return _apply_np(fn, _to(a))


def sinc(x):
    return _apply_np(lambda a: torch.sinc(_floating(a)), _to(x))


def copysign(x1, x2):
    return _binary_np(_int_ok(torch.copysign), _to(x1), _to(x2))


def rint(x):
    return _apply_np(torch.round, _to(x))


__all__ += [
    "blackman", "hamming", "hanning", "empty_like", "fabs", "isneginf",
    "isposinf", "ldexp", "logaddexp", "polyval", "vdot", "shape",
    "shares_memory", "diag_indices_from", "median", "nansum", "nanmax",
    "nanmin", "nanargmax", "nanargmin", "nancumsum", "take_along_axis",
    "isin", "in1d", "union1d", "intersect1d", "setdiff1d", "real", "imag",
    "conj", "positive", "float_power", "fmod", "divmod", "gcd", "lcm",
    "rollaxis", "sinc", "copysign", "rint",
]


# ------------------------------------------------------------ batch 4:
# NumPy's dispatch protocol: NumPy's functions and ufuncs called on
# mx.np arrays come back into this namespace, or run NumPy on host copies
# for a name it lacks, so onp.mean(a), onp.sin(a) and
# onp.concatenate([a, b]) work on mx.np.ndarray.
def _np_dispatch_lookup(name):
    fn = globals().get(name)
    if callable(fn):
        return fn
    return None


def _to_host(v):
    if isinstance(v, NDArray):
        return v.asnumpy()
    if isinstance(v, (list, tuple)):
        return type(v)(_to_host(x) for x in v)
    return v


def _ndarray_array_function(self, func, types, args, kwargs):
    ours = _np_dispatch_lookup(func.__name__)
    if ours is not None:
        try:
            return ours(*args, **kwargs)
        except TypeError:
            pass  # signature mismatch → host fallback below
    res = func(*_to_host(args), **{k: _to_host(v) for k, v in kwargs.items()})
    if isinstance(res, onp.ndarray):
        return array(res, ctx=self.context)
    return res


def _ndarray_array_ufunc(self, ufunc, method, *inputs, **kwargs):
    if method != "__call__":
        return NotImplemented
    out = kwargs.pop("out", None)
    ours = _np_dispatch_lookup(ufunc.__name__)
    if ours is not None and not kwargs:
        try:
            res = ours(*inputs)
            return _ufunc_apply_out(res, out)
        except TypeError:
            pass
    # host fallback: the remaining keywords (where=, casting=, ...) go to
    # NumPy, and out= rides along as host buffers seeded with the targets'
    # values so where=False positions keep their contents
    host_kwargs = {k: _to_host(v) for k, v in kwargs.items()}
    host_out = None
    if out is not None:
        targets = out if isinstance(out, tuple) else (out,)
        host_out = tuple(
            t.asnumpy().copy() if isinstance(t, ndarray) else t
            for t in targets)
        host_kwargs["out"] = host_out if isinstance(out, tuple) \
            else host_out[0]
    res = getattr(onp, ufunc.__name__)(*_to_host(inputs), **host_kwargs)
    if isinstance(res, onp.ndarray):
        res = array(res, ctx=self.context)
    elif isinstance(res, tuple):
        res = tuple(array(r, ctx=self.context) if isinstance(r, onp.ndarray)
                    else r for r in res)
    return _ufunc_apply_out(res, out, checked=host_out is not None)


def _ufunc_apply_out(res, out, checked=False):
    """ufunc ``out=``: the result written into the target mx ndarray(s),
    which are returned. ``checked`` means NumPy already ran with host
    ``out=`` buffers and enforced its casting rules; otherwise NumPy's
    same_kind output-casting rule is enforced here."""
    if out is None:
        return res
    targets = out if isinstance(out, tuple) else (out,)
    results = res if isinstance(res, tuple) else (res,)
    if len(targets) != len(results):
        raise ValueError("out= arity mismatch")
    written = []
    for t, r in zip(targets, results):
        if t is None:  # numpy allows None = "allocate this output"
            written.append(r)
            continue
        if not isinstance(t, ndarray):
            raise TypeError("out= target must be an mx np ndarray, got %r"
                            % type(t))
        r_t = r._data if isinstance(r, NDArray) else \
            _host(r).to(t._data.device)
        if r_t.dtype != t._data.dtype:
            src = onp.dtype(str(r_t.dtype).split(".")[-1])
            if not checked and not onp.can_cast(src, t.dtype,
                                                casting="same_kind"):
                raise TypeError(
                    "Cannot cast ufunc output from %s to %s with casting "
                    "rule 'same_kind'" % (src, t.dtype))
            r_t = r_t.to(t._data.dtype)
        t._data = r_t.to(t._data.device)
        written.append(t)
    # numpy normalizes out= to a tuple; hand back a bare array for the
    # single-output case
    return written[0] if len(written) == 1 else tuple(written)


def _ndarray_array(self, dtype=None, copy=None):
    a = self.asnumpy()
    return a.astype(dtype) if dtype is not None else a


ndarray.__array_function__ = _ndarray_array_function
ndarray.__array_ufunc__ = _ndarray_array_ufunc
ndarray.__array__ = _ndarray_array


# -------------------------------------------------- long-tail surface
# Imported last: fallback wraps the ndarray class defined above.
from . import fallback  # noqa: E402
from .fallback import *  # noqa: F401,F403,E402

__all__ += fallback.__all__
__all__ += ["bool_", "e", "float32", "float64", "inf", "int32", "int64",
            "nan", "newaxis", "pi", "uint8"]
__all__ = list(dict.fromkeys(__all__))
