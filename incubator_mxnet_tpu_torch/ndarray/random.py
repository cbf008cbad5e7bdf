"""Random sampling (counterpart of ``incubator_mxnet_tpu/ndarray/random.py``).

MXNet's stateful, seedable generator, as one explicit ``torch.Generator``
per device: ``seed(s)`` reseeds every device's generator (or only ``ctx``'s)
and the draws that follow repeat. The streams are torch's, not the JAX
package's threefry keys: the same seed gives the same distributions, not
the same values.
"""
from __future__ import annotations

import threading

import torch

from ..context import as_device
from .ndarray import NDArray, _apply, torch_dtype

__all__ = ["seed", "uniform", "normal", "randn", "randint", "exponential",
           "gamma", "poisson", "negative_binomial",
           "generalized_negative_binomial", "bernoulli", "multinomial",
           "shuffle"]


class _RngState(threading.local):
    def __init__(self):
        self.seed = 0
        self.generators = {}


_RNG = _RngState()


def seed(seed_state, ctx="all"):
    """Reseed every device's generator with ``seed_state``, or only the
    generator of ``ctx``."""
    seed_state = int(seed_state)
    if isinstance(ctx, str) and ctx == "all":
        _RNG.seed = seed_state
        for g in _RNG.generators.values():
            g.manual_seed(seed_state)
        return
    _generator(as_device(ctx)).manual_seed(seed_state)


def _generator(device):
    """The generator of ``device``, made (seeded with the last global seed)
    at first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _RNG.generators.get(device)
    if g is None:
        g = torch.Generator(device=device).manual_seed(_RNG.seed)
        _RNG.generators[device] = g
    return g


def _shape_of(shape, *params):
    if shape is None:
        for p in params:
            if isinstance(p, NDArray):
                return p.shape
        return (1,)
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _ctx_of(ctx, *params):
    for p in params:
        if isinstance(p, NDArray):
            return p.context
    return ctx


def _copy_out(res, out):
    if out is not None:
        out._data = res._data
        return out
    return res


def _draw(fn, shape, dtype, ctx, out):
    device = as_device(ctx)
    t = fn(tuple(shape), torch_dtype(dtype), device, _generator(device))
    return _copy_out(NDArray(t), out)


def uniform(low=0.0, high=1.0, shape=None, dtype="float32", ctx=None,
            out=None, **kw):
    """U[low, high). With NDArray bounds each of their elements gets
    ``shape`` samples: the output is the bounds' shape + ``shape``, as in
    MXNet."""
    if isinstance(low, NDArray) or isinstance(high, NDArray):
        extra = () if shape is None else _shape_of(shape)
        ref = low if isinstance(low, NDArray) else high
        device = ref._data.device
        g = _generator(device)

        def fn(lo, hi):
            base = torch.broadcast_shapes(
                *(t.shape for t in (lo, hi) if isinstance(t, torch.Tensor)))
            u = torch.rand(tuple(base) + extra, dtype=torch_dtype(dtype),
                           device=device, generator=g)
            pad = (1,) * len(extra)
            lo = lo.reshape(lo.shape + pad) if isinstance(
                lo, torch.Tensor) else lo
            hi = hi.reshape(hi.shape + pad) if isinstance(
                hi, torch.Tensor) else hi
            return lo + u * (hi - lo)
        return _copy_out(_apply(fn, low, high), out)
    return _draw(lambda s, dt, dev, g: torch.empty(s, dtype=dt, device=dev)
                 .uniform_(low, high, generator=g),
                 _shape_of(shape), dtype, ctx, out)


def normal(loc=0.0, scale=1.0, shape=None, dtype="float32", ctx=None,
           out=None, **kw):
    """N(loc, scale²)."""
    ctx = _ctx_of(ctx, loc, scale)
    shp = _shape_of(shape, loc, scale)
    if isinstance(loc, (int, float)) and isinstance(scale, (int, float)):
        # scalar moments: one draw, no operator (none of the JAX
        # package's is profiled either)
        return _draw(lambda s, dt, dev, g: loc + scale * torch.randn(
            s, dtype=dt, device=dev, generator=g), shp, dtype, ctx, out)
    draw = _draw(lambda s, dt, dev, g: torch.randn(s, dtype=dt, device=dev,
                                                    generator=g),
                 shp, dtype, ctx, None)
    return _copy_out(loc + scale * draw, out)


def randn(*shape, loc=0.0, scale=1.0, dtype="float32", ctx=None, **kw):
    return normal(loc, scale, shape or (1,), dtype, ctx)


def randint(low, high=None, shape=(1,), dtype="int32", ctx=None, out=None,
            **kw):
    """Integers in [low, high)."""
    if high is None:
        low, high = 0, low
    return _draw(lambda s, dt, dev, g: torch.randint(
        int(low), int(high), s, dtype=dt, device=dev, generator=g),
        _shape_of(shape), dtype, ctx, out)


def exponential(scale=1.0, shape=None, dtype="float32", ctx=None, out=None,
                **kw):
    """Exponential with mean ``scale``."""
    return _draw(lambda s, dt, dev, g: torch.empty(s, dtype=dt, device=dev)
                 .exponential_(1.0 / scale, generator=g),
                 _shape_of(shape, scale), dtype, ctx, out)


def gamma(alpha=1.0, beta=1.0, shape=None, dtype="float32", ctx=None,
          out=None, **kw):
    """Gamma with shape ``alpha`` and scale ``beta``."""
    def fn(s, dt, dev, g):
        a = torch.full(s, float(alpha), dtype=torch.float32, device=dev)
        return (beta * torch._standard_gamma(a, generator=g)).to(dt)
    return _draw(fn, _shape_of(shape, alpha, beta), dtype, ctx, out)


def poisson(lam=1.0, shape=None, dtype="float32", ctx=None, out=None, **kw):
    """Poisson with rate ``lam``."""
    def fn(s, dt, dev, g):
        rates = torch.full(s, float(lam), dtype=torch.float32, device=dev)
        return torch.poisson(rates, generator=g).to(dt)
    return _draw(fn, _shape_of(shape, lam), dtype, ctx, out)


def negative_binomial(k=1, p=1.0, shape=None, dtype="float32", ctx=None,
                      out=None, **kw):
    """Failures before the ``k``-th success at success rate ``p``: a
    Poisson draw whose rate is Gamma(k) · (1 - p) / p."""
    def fn(s, dt, dev, g):
        conc = torch.full(s, float(k), dtype=torch.float32, device=dev)
        rate = torch._standard_gamma(conc, generator=g) * ((1 - p) / p)
        return torch.poisson(rate, generator=g).to(dt)
    return _draw(fn, _shape_of(shape), dtype, ctx, out)


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=None,
                                  dtype="float32", ctx=None, out=None, **kw):
    """The negative binomial of mean ``mu`` and dispersion ``alpha``:
    ``k = 1 / alpha``, ``p = k / (k + mu)``."""
    k = 1.0 / alpha
    return negative_binomial(k, k / (k + mu), shape, dtype, ctx, out)


def _categorical(data, shape, get_prob, dtype, scalar_for_one):
    """Draws from the rows of probabilities ``data`` (last axis):
    ``data.shape[:-1] + shape`` of them (a 1-D ``data`` with ``shape``
    (1,) gives one 0-dim draw when ``scalar_for_one``), and with
    ``get_prob`` the log-probability of each."""
    n = 1
    for d in shape:
        n *= d

    def fn(p):
        rows = p.reshape(-1, p.shape[-1]).float()
        idx = torch.multinomial(rows, n, replacement=True,
                                generator=_generator(p.device))
        out_shape = tuple(p.shape[:-1]) + tuple(shape)
        if scalar_for_one and p.dim() == 1 and tuple(shape) == (1,):
            out_shape = ()
        draws = idx.reshape(out_shape)
        if not get_prob:
            return draws.to(torch_dtype(dtype))
        logp = torch.log(torch.gather(p.reshape(-1, p.shape[-1]), 1, idx))
        return draws.to(torch_dtype(dtype)), logp.reshape(out_shape)
    return _apply(fn, data)


def multinomial(data, shape=(1,), get_prob=False, dtype="int32", **kw):
    """Samples of the categorical distributions in the rows of ``data``
    (probabilities over the last axis): ``data.shape[:-1] + shape`` (a
    1-D ``data`` with the default shape gives one 0-dim sample); with
    ``get_prob`` also the log-probability of each sample."""
    return _categorical(data, (shape,) if isinstance(shape, int)
                        else tuple(shape), get_prob, dtype, True)


def bernoulli(prob=None, logit=None, shape=None, dtype="float32", ctx=None,
              **kw):
    """1 with probability ``prob`` (or ``sigmoid(logit)``), else 0; the
    shape of ``prob`` (a scalar gives a 0-dim array) unless ``shape`` is
    given."""
    p = prob if prob is not None else logit
    ctx = _ctx_of(ctx, p)
    device = as_device(ctx)
    p = p._data if isinstance(p, NDArray) else torch.tensor(
        float(p), device=device)
    if prob is None:
        p = torch.sigmoid(p)
    p = p.float()
    if shape:
        p = p.expand(_shape_of(shape))
    t = torch.bernoulli(p, generator=_generator(device))
    return NDArray(t.to(torch_dtype(dtype)))


def shuffle(data, **kw):
    """The rows of ``data`` (its first axis) in a random order."""
    def fn(x):
        perm = torch.randperm(x.shape[0], device=x.device,
                              generator=_generator(x.device))
        return x[perm]
    return _apply(fn, data)

