"""Weight initializers (counterpart of ``incubator_mxnet_tpu/initializer.py``).

An initializer fills a tensor in place, ``init(name, tensor, generator)``,
drawing every random number from the explicit ``torch.Generator`` it is
given. The generator and the tensor lie on the same device (the caller,
``gluon.Parameter``, fills on the generator's device and then moves).
"""
from __future__ import annotations

import math

import torch

from .base import registry

__all__ = ["Initializer", "Zero", "One", "Uniform", "Normal", "Xavier",
           "register", "create"]

_REG = registry("initializer")
register = _REG.register


class Initializer:
    """Base initializer: dispatches on the parameter name's suffix (bias and
    beta → 0, gamma → 1), everything else to ``_init_weight``."""

    @torch.no_grad()
    def __call__(self, name, arr, generator=None):
        name = str(name)
        if name.endswith("bias") or name.endswith("beta"):
            arr.zero_()
        elif name.endswith("gamma"):
            arr.fill_(1.0)
        else:
            self._init_weight(name, arr, generator)

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError


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
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Xavier(Initializer):
    """Xavier/Glorot: gaussian or uniform, fan averaged, in or out."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
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


def create(name, **kwargs):
    if isinstance(name, Initializer):
        return name
    return _REG.create(name, **kwargs)
