"""``npx.random`` (counterpart of
``incubator_mxnet_tpu/numpy_extension/random.py``; MXNet's seed /
bernoulli / normal_n / uniform_n). Draws come from the port's seedable
generator of the parameters' (else the current context's) device."""
from __future__ import annotations

import torch

from ..context import as_device
from ..ndarray import NDArray
from ..ndarray.ndarray import torch_dtype
from ..ndarray.random import _generator
from ..numpy import ndarray as np_ndarray

__all__ = ["seed", "bernoulli", "normal_n", "uniform_n"]


def seed(s):
    from ..ndarray import random as _r
    _r.seed(s)


def _param(x, device=None):
    if isinstance(x, NDArray):
        return x._data.float()
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _device(*xs):
    for x in xs:
        if isinstance(x, NDArray):
            return x._data.device
    return as_device(None)


def bernoulli(prob=None, logit=None, size=None, dtype="float32", **kw):
    """Draws with P(1) = prob, or sigmoid(logit) when given logits
    (exactly one of prob/logit, as the reference enforces)."""
    if (prob is None) == (logit is None):
        raise ValueError("pass exactly one of prob / logit")
    dev = _device(prob, logit)
    p = torch.sigmoid(_param(logit, dev)) if prob is None else \
        _param(prob, dev)
    shp = size if isinstance(size, tuple) else \
        ((size,) if size is not None else tuple(p.shape))
    p = torch.broadcast_to(p, shp).contiguous()
    return np_ndarray(torch.bernoulli(p, generator=_generator(dev))
                      .to(torch_dtype(dtype)))


def _batch_shape(batch_shape):
    if batch_shape is None:
        return ()
    return batch_shape if isinstance(batch_shape, tuple) else (batch_shape,)


def normal_n(loc=0.0, scale=1.0, batch_shape=None, dtype="float32", **kw):
    """MXNet's npx.random.normal_n: ``batch_shape`` PREPENDS to the
    broadcast parameter shape (n independent draws per parameter
    setting)."""
    dev = _device(loc, scale)
    loc_, scale_ = _param(loc, dev), _param(scale, dev)
    shp = _batch_shape(batch_shape) + tuple(
        torch.broadcast_shapes(loc_.shape, scale_.shape))
    z = torch.randn(shp, device=dev, generator=_generator(dev))
    return np_ndarray((loc_ + scale_ * z).to(torch_dtype(dtype)))


def uniform_n(low=0.0, high=1.0, batch_shape=None, dtype="float32", **kw):
    dev = _device(low, high)
    low_, high_ = _param(low, dev), _param(high, dev)
    shp = _batch_shape(batch_shape) + tuple(
        torch.broadcast_shapes(low_.shape, high_.shape))
    u = torch.rand(shp, device=dev, generator=_generator(dev))
    return np_ndarray((low_ + (high_ - low_) * u).to(torch_dtype(dtype)))
