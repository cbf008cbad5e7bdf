"""Shared small utilities (counterpart of ``incubator_mxnet_tpu/base.py``)."""
from __future__ import annotations

import numpy as onp

__all__ = ["MXNetError", "string_types", "numeric_types", "Registry",
           "registry", "public_op_names", "distributed_is_initialized",
           "enable_x64"]


class MXNetError(RuntimeError):
    """The framework's error type (MXNet's ``base.MXNetError``)."""


string_types = (str,)
numeric_types = (float, int, onp.generic)


class Registry:
    """Name→class registry (names are case-insensitive)."""

    def __init__(self, name):
        self.name = name
        self._registry = {}

    def register(self, klass, name=None):
        nm = (name or klass.__name__).lower()
        self._registry[nm] = klass
        return klass

    def alias(self, *aliases):
        """Class decorator: register the class under its own name and
        under each of ``aliases``."""
        def reg(klass):
            self.register(klass)
            for a in aliases:
                self.register(klass, a)
            return klass
        return reg

    def get(self, name):
        if isinstance(name, str):
            key = name.lower()
            if key not in self._registry:
                raise ValueError(
                    "%s %r not registered; known: %s"
                    % (self.name, name, sorted(self._registry)))
            return self._registry[key]
        return name

    def create(self, name, *args, **kwargs):
        if not isinstance(name, str):
            return name
        return self.get(name)(*args, **kwargs)

    def __contains__(self, name):
        return isinstance(name, str) and name.lower() in self._registry

    def keys(self):
        return self._registry.keys()


_registries = {}


def registry(name):
    if name not in _registries:
        _registries[name] = Registry(name)
    return _registries[name]


def public_op_names(namespace, exclude=()):
    """Public operator-like callables of a namespace: everything that is
    not underscored, a module, a class, or in ``exclude``. The one rule the
    ``nd`` → ``sym`` registration (``symbol/__init__.py``) and the tests
    share about what counts as an op."""
    import inspect
    import types
    out = []
    for n in sorted(dir(namespace)):
        if n.startswith("_") or n in exclude:
            continue
        o = getattr(namespace, n)
        if isinstance(o, types.ModuleType) or inspect.isclass(o) or \
                not callable(o):
            continue
        out.append(n)
    return out


def distributed_is_initialized():
    """Whether a ``torch.distributed`` process group is up (the JAX
    package asks ``jax.distributed`` the same)."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def enable_x64(enabled=True):
    """The JAX package's scoped 64-bit switch. Torch has int64 and float64
    types always, so this is a context that changes nothing."""
    import contextlib
    return contextlib.nullcontext(enabled)
