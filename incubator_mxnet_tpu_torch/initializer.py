"""Weight initializers (counterpart of ``incubator_mxnet_tpu/initializer.py``).

An initializer fills a tensor in place, ``init(name, tensor, generator)``,
drawing every random number from the explicit ``torch.Generator`` it is
given. The generator and the tensor lie on the same device (the caller,
``gluon.Parameter``, fills on the generator's device and then moves).
"""
from __future__ import annotations

import math
import re

import numpy as onp
import torch

from .base import registry

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "register", "create"]

_REG = registry("initializer")
register = _REG.register


class Initializer:
    """Base initializer: dispatches on the parameter name (bias and beta →
    0, gamma → 1, a running or moving mean → 0 and variance → 1, as the
    JAX package's ``init_weight_by_name``), everything else to
    ``_init_weight``. ``dumps()`` gives MXNet's JSON description: the
    lower-cased class name and the constructor's keywords."""

    _kwargs = {}

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, name, arr, generator=None):
        self.init_weight_by_name(str(name), arr, generator)

    @torch.no_grad()
    def init_weight_by_name(self, name, arr, generator=None):
        if name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        elif "running_mean" in name or "moving_mean" in name:
            arr.zero_()
        elif "running_var" in name or "moving_var" in name:
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])


@register
class Zero(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.zero_()


@register
class One(Initializer):
    def _init_weight(self, name, arr, generator):
        arr.fill_(1.0)


_REG.register(Zero, "zeros")
_REG.register(One, "ones")


@register
class Constant(Initializer):
    """Every entry ``value``."""

    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of a (out, prod(rest)) draw,
    uniform(-1, 1) or normal(0, 1) (``rand_type``): its rows (or columns)
    are orthonormal, so ``QᵀQ = scale²·I`` on the smaller side."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:]) if arr.dim() > 1 else 1
        tmp = torch.empty((nout, nin), device=arr.device)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """Xavier/Glorot: gaussian or uniform, fan averaged, in or out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        if len(shape) < 2:
            raise ValueError("Xavier requires ndim >= 2, got %s for %s"
                             % (tuple(shape), name))
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)


@register
class MSRAPrelu(Xavier):
    """He initialisation for PReLU nets: normal with variance
    ``2 / ((1 + slope²) · fan)``."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes, for a
    transposed convolution that upsamples."""

    def _init_weight(self, name, arr, generator):
        shape = tuple(arr.shape)
        f = shape[3] / 2.0
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        x = onp.arange(shape[3]).reshape(1, -1)
        y = onp.arange(shape[2]).reshape(-1, 1)
        kernel = (1 - onp.abs(x / f - c)) * (1 - onp.abs(y / f - c))
        weight = onp.broadcast_to(kernel, shape).astype(onp.float32)
        arr.copy_(torch.from_numpy(weight))


@register
class LSTMBias(Initializer):
    """Zeros, but ``forget_bias`` on the forget gate's slice [H, 2H) of an
    LSTM's (4H,) bias (gates i, f, g, o)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, name, arr, generator):
        num_hidden = arr.shape[0] // 4
        arr.zero_()
        arr[num_hidden:2 * num_hidden] = self.forget_bias


class Mixed(Initializer):
    """The first initializer whose pattern matches the parameter's name
    (``re.match``) fills it; no match raises."""

    def __init__(self, patterns, initializers):
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        for pat, init in self.map:
            if pat.match(str(name)):
                init(name, arr, generator)
                return
        raise ValueError("no initializer pattern matches %r" % (name,))

    def _init_weight(self, name, arr, generator):
        self(name, arr, generator)


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)
