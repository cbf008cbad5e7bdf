"""``mx.np``'s long tail (counterpart of
``incubator_mxnet_tpu/numpy/fallback.py``; MXNet's
``python/mxnet/numpy/fallback.py``).

The reference runs these names on the device through ``jnp``. Here a name
that one torch operator computes runs in torch on the array's device
(``_DEVICE_FNS``); a name torch has no operator for (``apply_along_axis``,
``partition``, ``choose``, ``select``, the polynomials, the
multi-dimensional histograms, ...) computes with NumPy on the host and
returns on the array's device (``_HOST_FNS``), as MXNet's own fallback
does. File io (``genfromtxt``), the scalar and type queries and the legacy
financial functions (``npv``, ``pv``, ... — dropped from NumPy >= 1.20 but
still in the reference's surface) run on the host in both packages.

As in the reference, names in this module are not recorded on the autograd
tape.
"""
from __future__ import annotations

import builtins

import numpy as onp
import torch

from ..context import as_device, context_of
from ..ndarray import NDArray

#: names one torch operator computes, on the array's device
_DEVICE_FNS = [
    "frexp", "i0", "lexsort", "modf", "nancumprod", "nanmedian",
    "nanpercentile", "nanquantile", "tril_indices_from", "triu_indices_from",
]
#: names torch has no operator for: NumPy on the host, the result on the
#: array's device
_HOST_FNS = [
    "apply_along_axis", "apply_over_axes", "argpartition", "array_equiv",
    "choose", "correlate", "histogram2d", "histogram_bin_edges",
    "histogramdd", "ix_", "packbits", "partition", "piecewise", "poly",
    "polyadd", "polyfit", "polyint", "polymul", "polysub", "roots",
    "select", "setxor1d", "trim_zeros", "unpackbits", "unwrap",
]
#: the reference's list, in its order
_JNP_FNS = [
    "apply_along_axis", "apply_over_axes", "argpartition", "array_equiv",
    "choose", "correlate", "frexp", "histogram2d", "histogram_bin_edges",
    "histogramdd", "i0", "ix_", "lexsort", "modf", "nancumprod",
    "nanmedian", "nanpercentile", "nanquantile", "packbits", "partition",
    "piecewise", "poly", "polyadd", "polydiv", "polyfit", "polyint",
    "polymul", "polysub", "roots", "select", "setxor1d",
    "tril_indices_from", "triu_indices_from", "trim_zeros", "unpackbits",
    "unwrap",
]

__all__ = _JNP_FNS + [
    "alltrue", "msort", "genfromtxt", "spacing", "min_scalar_type",
    "promote_types", "result_type", "set_printoptions", "ndim", "size",
    "dtype", "finfo", "iinfo", "npv", "mirr", "pv", "ppmt",
    "rate", "NAN", "NaN", "NINF", "NZERO", "PINF", "PZERO", "bool",
    "bool_", "int8", "int16", "float16", "_NoValue", "_STR_2_DTYPE_",
    "__version__",
]


def _np():
    from . import ndarray as np_ndarray, _narrow
    return np_ndarray, _narrow


def _device_of(args, kwargs):
    for x in list(args) + list(kwargs.values()):
        if isinstance(x, NDArray):
            return x._data.device
        if isinstance(x, (list, tuple)):
            for e in x:
                if isinstance(e, NDArray):
                    return e._data.device
    return as_device(None)


def _tx(x, device):
    """Arguments as tensors: NDArrays' own, lists of them element-wise."""
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)) and any(isinstance(e, NDArray)
                                            for e in x):
        return type(x)(_tx(e, device) for e in x)
    return x


def _hx(x):
    """Arguments as host NumPy arrays (bfloat16 widened)."""
    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_hx(v) for v in x)
    return x


def _wrap_out(r, device):
    np_ndarray, narrow = _np()
    if isinstance(r, (tuple, list)):
        return type(r)(_wrap_out(v, device) for v in r)
    if isinstance(r, torch.Tensor):
        return np_ndarray(narrow(r.to(device)))
    if isinstance(r, onp.ndarray) and r.dtype != object:
        from . import array
        return array(r, ctx=context_of(torch.empty(0, device=device)))
    return r


def _device_fn(name, impl):
    def fn(*args, **kwargs):
        dev = _device_of(args, kwargs)
        return _wrap_out(impl(*[_tx(a, dev) for a in args],
                              **{k: _tx(v, dev) for k, v in kwargs.items()}),
                         dev)
    fn.__name__ = name
    fn.__doc__ = "mx.np.%s: torch on the array's device" % name
    return fn


def _host_fn(name, impl):
    def fn(*args, **kwargs):
        dev = _device_of(args, kwargs)
        return _wrap_out(impl(*[_hx(a) for a in args],
                              **{k: _hx(v) for k, v in kwargs.items()}), dev)
    fn.__name__ = name
    fn.__doc__ = ("mx.np.%s: NumPy on the host (torch has no such "
                  "operator), the result on the array's device" % name)
    return fn


def _f(x):
    return x if x.is_floating_point() or x.is_complex() else \
        x.to(torch.float32)


# ---------------------------------------------------- torch on the device
def _frexp(x):
    m, e = torch.frexp(_f(x))
    return m, e.to(torch.int32)


def _lexsort(keys, axis=-1):
    keys = list(keys) if not isinstance(keys, torch.Tensor) else \
        [keys[i] for i in range(keys.shape[0])]
    order = torch.argsort(keys[0], dim=axis, stable=True)
    for k in keys[1:]:
        order = torch.gather(order, axis, torch.argsort(
            torch.gather(k, axis, order), dim=axis, stable=True))
    return order


def _modf(x):
    x = _f(x)
    i = torch.trunc(x)
    return x - i, i


def _nancumprod(a, axis=None):
    from . import _flat_axis
    if a.is_floating_point():
        a = torch.where(torch.isnan(a), torch.ones_like(a), a)
    a, ax = _flat_axis(a, axis)
    return torch.cumprod(a, dim=ax).to(a.dtype)


def _nanq(a, q, axis, keepdims, method, scale):
    from . import _axes, _q_arg, _quantile_along
    return _quantile_along(a, _q_arg(q, a, scale), _axes(axis, a), keepdims,
                           method, nan=True)


def _nanmedian(a, axis=None, out=None, overwrite_input=False,
               keepdims=False):
    from . import _axes, _quantile_along
    return _quantile_along(a, 0.5, _axes(axis, a), keepdims, "midpoint",
                           nan=True)


def _nanpercentile(a, q, axis=None, out=None, overwrite_input=False,
                   method="linear", keepdims=False, **kw):
    return _nanq(a, q, axis, keepdims, method, 100.0)


def _nanquantile(a, q, axis=None, out=None, overwrite_input=False,
                 method="linear", keepdims=False, **kw):
    return _nanq(a, q, axis, keepdims, method, 1.0)


def _tri_from(fn):
    def op(arr, k=0):
        n, m = arr.shape[-2:]
        t = fn(n, m, k, device=arr.device)
        return t[0], t[1]
    return op


_DEVICE_IMPL = {
    "frexp": _frexp, "i0": lambda x: torch.i0(_f(x)), "lexsort": _lexsort,
    "modf": _modf, "nancumprod": _nancumprod, "nanmedian": _nanmedian,
    "nanpercentile": _nanpercentile, "nanquantile": _nanquantile,
    "tril_indices_from": _tri_from(torch.tril_indices),
    "triu_indices_from": _tri_from(torch.triu_indices)}


def _polydiv(u, v):
    """NumPy's quotient, and its remainder padded back to ``u``'s length
    with leading zeros: the reference keeps the whole-length remainder
    (``trim_leading_zeros=False``), whose leading entries NumPy drops
    where they are within 1e-8 of 0."""
    q, r = onp.polydiv(u, v)
    return q, onp.concatenate([onp.zeros(onp.size(u) - r.size, r.dtype), r])


_g = globals()
for _n in _DEVICE_FNS:
    _g[_n] = _device_fn(_n, _DEVICE_IMPL[_n])
for _n in _HOST_FNS:
    _g[_n] = _host_fn(_n, getattr(onp, _n))
polydiv = _host_fn("polydiv", _polydiv)


def alltrue(a, axis=None, out=None, keepdims=False):
    """The legacy alias of ``all``."""
    from . import all as _all
    return _all(a, axis=axis, keepdims=keepdims)


def msort(a):
    """``sort(a, axis=0)`` (removed from NumPy 2)."""
    dev = _device_of((a,), {})
    return _wrap_out(torch.sort(_tx(a, dev), dim=0, stable=True).values, dev)


genfromtxt = _host_fn("genfromtxt", onp.genfromtxt)     # host file io


# -------------------------------------------------- scalar / meta queries
def spacing(x):
    return onp.spacing(x.asnumpy() if isinstance(x, NDArray) else x)


def min_scalar_type(a):
    return onp.min_scalar_type(a.asnumpy() if isinstance(a, NDArray) else a)


def _torch_type(t):
    from ..ndarray.ndarray import torch_dtype
    return torch_dtype(t)


def _numpy_type(t):
    from . import _NARROW
    t = _NARROW.get(t, t)
    return onp.dtype(str(t).split(".")[-1])


def promote_types(t1, t2):
    """JAX's type lattice (which torch's follows: float32 with int32 is
    float32), not NumPy's."""
    return _numpy_type(torch.promote_types(_torch_type(t1), _torch_type(t2)))


def result_type(*args):
    """The type of an operation on ``args``, JAX's rules: arrays and types
    by the lattice, Python numbers only where no array or type sets the
    kind."""
    strong = None
    weak = []
    for a in args:
        if isinstance(a, NDArray):
            t = a._data.dtype
        elif isinstance(a, (builtins.bool, int, float, complex)):
            weak.append(a)
            continue
        else:
            t = _torch_type(a)
        strong = t if strong is None else torch.promote_types(strong, t)
    if strong is None:
        strong = torch.result_type(torch.tensor(weak[0]), weak[0]) if weak \
            else torch.float32
        for w in weak[1:]:
            strong = torch.result_type(torch.empty((), dtype=strong), w)
    else:
        for w in weak:
            strong = torch.result_type(torch.empty(1, dtype=strong), w)
    return _numpy_type(strong)


set_printoptions = onp.set_printoptions


def ndim(a):
    return len(a.shape) if isinstance(a, NDArray) else onp.ndim(a)


def size(a, axis=None):
    if isinstance(a, NDArray):
        return a.shape[axis] if axis is not None else int(onp.prod(a.shape))
    return onp.size(a, axis)


# (`shape` deliberately NOT defined here: mx.np already exports it)
dtype = onp.dtype
finfo = onp.finfo
iinfo = onp.iinfo


# ---------------------------------------- legacy financial functions (host)
# NumPy >= 1.20 moved these to numpy-financial; the reference's exported
# surface still carries them, so the standard closed forms live here.
def npv(rate, values):
    v = onp.asarray(_as_host(values), dtype="float64")
    return float((v / (1.0 + rate) ** onp.arange(v.size)).sum())


def _as_host(x):
    return x.asnumpy() if isinstance(x, NDArray) else onp.asarray(x)


def mirr(values, finance_rate, reinvest_rate):
    v = onp.asarray(_as_host(values), dtype="float64")
    n = v.size
    pos, neg = onp.where(v > 0, v, 0.0), onp.where(v < 0, v, 0.0)
    if not (pos.any() and neg.any()):
        return float("nan")
    fv = npv(reinvest_rate, pos) * (1 + reinvest_rate) ** (n - 1)
    pv_ = npv(finance_rate, neg) * (1 + finance_rate)
    return float((fv / -pv_) ** (1.0 / (n - 1)) - 1)


def pv(rate, nper, pmt, fv=0, when=0):
    when = {"end": 0, "begin": 1}.get(when, when)
    if rate == 0:
        return -(fv + pmt * nper)
    tmp = (1 + rate) ** nper
    return -(fv + pmt * (1 + rate * when) * (tmp - 1) / rate) / tmp


def _pmt(rate, nper, pv_, fv=0, when=0):
    if rate == 0:
        return -(fv + pv_) / nper
    tmp = (1 + rate) ** nper
    return -(fv + pv_ * tmp) * rate / ((1 + rate * when) * (tmp - 1))


def ppmt(rate, per, nper, pv_, fv=0, when=0):
    when = {"end": 0, "begin": 1}.get(when, when)
    total = _pmt(rate, nper, pv_, fv, when)
    # interest part: remaining balance after per-1 periods times rate
    bal = pv_ * (1 + rate) ** (per - 1) + \
        total * (((1 + rate) ** (per - 1) - 1) / rate if rate else per - 1)
    ipmt = -bal * rate
    if when == 1:
        ipmt = ipmt / (1 + rate)
    return total - ipmt


def rate(nper, pmt, pv_, fv, when=0, guess=0.1, tol=1e-6, maxiter=100):
    """Newton iteration on the annuity identity (numpy-financial rate)."""
    when = {"end": 0, "begin": 1}.get(when, when)
    r = guess
    for _ in range(maxiter):
        t = (1 + r) ** nper
        f = fv + pv_ * t + pmt * (1 + r * when) * (t - 1) / r
        df = (nper * pv_ * (1 + r) ** (nper - 1)
              + pmt * (when * (t - 1) / r
                       + (1 + r * when) * (nper * (1 + r) ** (nper - 1) * r
                                           - (t - 1)) / (r * r)))
        step = f / df
        r -= step
        if abs(step) < tol:
            return r
    return float("nan")


# -------------------------------------------------------- np constants
NAN = NaN = float("nan")
NINF = float("-inf")
PINF = float("inf")
NZERO = -0.0
PZERO = 0.0
bool = onp.bool_    # noqa: A001  (MXNet's multiarray exports `bool`)
bool_ = onp.bool_
int8 = onp.int8
int16 = onp.int16
float16 = onp.float16
_NoValue = getattr(onp, "_NoValue", object())
#: MXNet's multiarray._STR_2_DTYPE_: the dtype-string lookup of array()
_STR_2_DTYPE_ = {k: onp.dtype(k) for k in
                 ("int8", "uint8", "int16", "int32", "int64", "float16",
                  "float32", "float64", "bool")}
__version__ = "1.0.0"

