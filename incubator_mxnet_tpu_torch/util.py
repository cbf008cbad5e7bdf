"""Utility scopes and flags (counterpart of ``incubator_mxnet_tpu/util.py``;
MXNet's ``python/mxnet/util.py``).

The ``np_shape``/``np_array`` flags are thread-local, as in the JAX
package: ``set_np``/``reset_np`` set both, the ``np_shape``/``np_array``
scopes set one for a block (or, used as decorators, for a call), and
``use_np`` sets both for a call. ``inspect_tensor`` logs an array's stats
and can write it as ``<dump_dir>/<tag>.npy``.
"""
from __future__ import annotations

import functools
import threading

__all__ = ["inspect_tensor",
           "is_np_shape", "is_np_array", "set_np_shape", "set_np", "reset_np",
           "np_shape", "np_array", "use_np", "getenv", "setenv"]


class _Flags(threading.local):
    def __init__(self):
        self.np_shape = False
        self.np_array = False


_F = _Flags()


def is_np_shape():
    return _F.np_shape


def is_np_array():
    return _F.np_array


def set_np_shape(active):
    """Set the ``np_shape`` flag; returns its previous value."""
    prev = _F.np_shape
    _F.np_shape = bool(active)
    return prev


def set_np(shape=True, array=True):
    """Turn NumPy semantics on (or off) for this thread."""
    _F.np_shape = shape
    _F.np_array = array


def reset_np():
    set_np(False, False)


class _Scope:
    """One flag set to ``value`` inside a ``with`` block, or around each
    call of a function it decorates."""

    def __init__(self, attr, value):
        self.attr = attr
        self.value = value

    def __enter__(self):
        self.prev = getattr(_F, self.attr)
        setattr(_F, self.attr, self.value)
        return self

    def __exit__(self, *a):
        setattr(_F, self.attr, self.prev)

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with type(self)(self.attr, self.value):
                return fn(*args, **kwargs)
        return wrapped


def np_shape(active=True):
    return _Scope("np_shape", active)


def np_array(active=True):
    return _Scope("np_array", active)


def use_np(fn):
    """Run ``fn`` with both flags on."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with _Scope("np_shape", True), _Scope("np_array", True):
            return fn(*args, **kwargs)
    return wrapped


def getenv(name):
    import os
    return os.environ.get(name)


def setenv(name, value):
    import os
    os.environ[name] = value


def inspect_tensor(data, tag="", check_nan=True, check_inf=True,
                   dump_dir=None, logger=None):
    """Log an array's shape, dtype, min/max/mean/std and NaN/Inf counts
    (MXNet's ``TensorInspector``); with ``dump_dir`` write it as
    ``<dump_dir>/<tag>.npy``. ``data`` is an NDArray, a tensor or anything
    numpy reads; ``logger=False`` logs nothing. Returns the stats dict."""
    import logging as _logging
    import numpy as onp
    log = (logger or _logging).info if logger is not False else (lambda *a: None)
    if hasattr(data, "asnumpy"):
        a = data.asnumpy()
    elif hasattr(data, "detach"):
        a = data.detach().cpu().numpy()
    else:
        a = onp.asarray(data)
    af = a.astype("float64") if a.dtype.kind in "fiu" else None
    stats = {"tag": tag, "shape": tuple(a.shape), "dtype": str(a.dtype)}
    if af is not None and af.size:
        stats.update({
            "min": float(onp.nanmin(af)), "max": float(onp.nanmax(af)),
            "mean": float(onp.nanmean(af)), "std": float(onp.nanstd(af)),
            "nan_count": int(onp.isnan(af).sum()) if check_nan else None,
            "inf_count": int(onp.isinf(af).sum()) if check_inf else None,
        })
    log("inspect[%s]: %s", tag, stats)
    if dump_dir is not None:
        import os
        os.makedirs(dump_dir, exist_ok=True)
        onp.save(os.path.join(dump_dir, "%s.npy" % (tag or "tensor")), a)
    return stats
