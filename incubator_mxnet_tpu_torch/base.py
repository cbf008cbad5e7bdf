"""Shared small utilities (counterpart of ``incubator_mxnet_tpu/base.py``)."""
from __future__ import annotations

__all__ = ["Registry", "registry"]


class Registry:
    """Name→class registry (names are case-insensitive)."""

    def __init__(self, name):
        self.name = name
        self._registry = {}

    def register(self, klass, name=None):
        nm = (name or klass.__name__).lower()
        self._registry[nm] = klass
        return klass

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


_registries = {}


def registry(name):
    if name not in _registries:
        _registries[name] = Registry(name)
    return _registries[name]
