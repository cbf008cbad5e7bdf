"""Parameter & ParameterDict over ``torch.nn.Parameter`` (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` keeps the MXNet contract — a declared shape that may be
deferred (0 entries) until the first forward, an ``init`` of its own,
``initialize(init, ctx)``, ``data()`` and ``cast()`` — and holds its value
as one ``nn.Parameter``. The block that owns it registers that tensor under
the attribute name, so ``state_dict()`` and ``named_parameters()`` see it.
``cast`` swaps the tensor's storage in place, which keeps the registered
object (and any sharing, such as a tied embedding) intact.

The gradient is torch's: ``grad()`` reads the tensor's ``.grad``, which a
backward fills (a tied weight gets the sum of its uses) and
``Trainer.step`` / ``TrainStep`` consume. ``lr_mult`` and ``wd_mult``
scale the optimizer's learning rate and weight decay for this parameter.
"""
from __future__ import annotations

import numpy as onp
import torch

from .. import initializer as init_mod
from ..context import as_device
from ..ndarray import torch_dtype

__all__ = ["Parameter", "ParameterDict", "DeferredInitializationError"]


class DeferredInitializationError(Exception):
    """Parameter used before its shape was known."""


class Parameter:
    """A parameter with an MXNet-style (possibly deferred) shape."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False):
        self.name = name
        self.grad_req = grad_req
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = tuple(shape) if shape is not None else None
        self.dtype = dtype
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self._data = None            # nn.Parameter once initialized
        self._deferred_init = None   # (init, default_init, device, generator)
        self._owners = []            # (module, attribute) registrations

    @property
    def shape(self):
        return self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(new_shape)
        if self._shape is not None and (
                len(self._shape) != len(new_shape)
                or any(s1 not in (0, -1, None) and s1 != s2
                       for s1, s2 in zip(self._shape, new_shape))):
            raise ValueError("Cannot overwrite shape %s with %s for "
                             "Parameter %s" % (self._shape, new_shape,
                                               self.name))
        self._shape = new_shape

    def _shape_known(self):
        return self._shape is not None and all(s > 0 for s in self._shape)

    def _attach(self, module, attr):
        """Register this parameter's tensor on ``module`` as ``attr``."""
        self._owners.append((module, attr))
        module._parameters[attr] = self._data

    # ----------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False, generator=None):
        """Allocate and fill on ``ctx``. ``init`` overrides the parameter's
        own initializer; ``default_init`` is used when neither is set.
        Random draws come from ``generator`` (default: a fresh CPU
        generator seeded 0)."""
        if self._data is not None and not force_reinit:
            return
        device = as_device(ctx)
        if default_init is None:
            default_init = init_mod.Uniform()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if not self._shape_known():
            if self.allow_deferred_init:
                self._deferred_init = (init, default_init, device, generator)
                return
            raise ValueError("Cannot initialize Parameter %s because it has "
                             "invalid shape %s." % (self.name, self._shape))
        self._finish_init(init, default_init, device, generator)

    def _finish_init(self, init, default_init, device, generator):
        buf = torch.empty(self._shape, dtype=torch.float32,
                          device=generator.device)
        explicit = self.init if init is None else init
        if explicit is None:
            default_init(self.name, buf, generator)
        else:
            # an explicit per-parameter init bypasses the suffix dispatch
            with torch.no_grad():
                init_mod.create(explicit)._init_weight(self.name, buf,
                                                       generator)
        data = buf.to(device=device, dtype=torch_dtype(self.dtype))
        if self._data is None:
            self._data = torch.nn.Parameter(
                data, requires_grad=self.grad_req != "null")
            for module, attr in self._owners:
                module._parameters[attr] = self._data
        else:
            self._data.data = data
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s" % (self.name, self._shape))
        self._finish_init(*self._deferred_init)

    # ----------------------------------------------------------------
    def data(self, ctx=None):
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s was not initialized because it has unknown "
                    "shape %s. Run a forward pass first."
                    % (self.name, self._shape))
            raise RuntimeError("Parameter %s has not been initialized. Call "
                               ".initialize() first." % self.name)
        return self._data

    def grad(self, ctx=None):
        """The gradient of the last backward(s), zeros before any."""
        if self.grad_req == "null":
            raise RuntimeError("Parameter %s has grad_req='null'" % self.name)
        data = self.data()
        return data.grad if data.grad is not None else torch.zeros_like(data)

    def zero_grad(self):
        if self._data is not None:
            self._data.grad = None

    def list_ctx(self):
        """[the Context this parameter lives on]."""
        from ..context import Context
        device = self.data().device
        return [Context("gpu" if device.type == "cuda" else "cpu",
                        device.index or 0)]

    @torch.no_grad()
    def set_data(self, data):
        """Copy ``data`` (tensor or numpy array) into this parameter, in its
        dtype and on its device."""
        if not isinstance(data, torch.Tensor):
            data = torch.from_numpy(onp.array(data))
        self.data().copy_(data)

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            self._data.data = self._data.data.to(torch_dtype(dtype))

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                     self.dtype)


class ParameterDict:
    """Ordered name → Parameter map."""

    def __init__(self):
        self._params = {}

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def __iter__(self):
        return iter(self._params)

    def __getitem__(self, key):
        return self._params[key]

    def __contains__(self, key):
        return key in self._params

    def __len__(self):
        return len(self._params)

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update because keys overlap: %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, force_reinit=False,
                   generator=None):
        """Initialize every parameter; ``init`` is the default initializer
        for parameters without one of their own. One generator feeds them
        all, in key order, so a seed fixes the whole model."""
        init = init_mod.Uniform() if init is None else init_mod.create(init)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)

    def cast(self, dtype):
        for p in self.values():
            p.cast(dtype)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()
