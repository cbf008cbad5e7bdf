"""Scoped attributes (counterpart of ``incubator_mxnet_tpu/attribute.py``):
``with AttrScope(key=value):`` adds attributes that nested scopes
inherit and extend."""
from __future__ import annotations

import threading

__all__ = ["AttrScope", "current"]


class AttrScope:
    _current = threading.local()

    def __init__(self, **kwargs):
        self._attr = kwargs
        self._old_scope = None

    def get(self, attr=None):
        """This scope's attributes updated with ``attr``."""
        if self._attr:
            ret = self._attr.copy()
            if attr:
                ret.update(attr)
            return ret
        return attr if attr else {}

    def __enter__(self):
        if not hasattr(AttrScope._current, "value"):
            AttrScope._current.value = AttrScope()
        self._old_scope = AttrScope._current.value
        attr = AttrScope._current.value._attr.copy()
        attr.update(self._attr)
        self._attr = attr
        AttrScope._current.value = self
        return self

    def __exit__(self, *args):
        AttrScope._current.value = self._old_scope


def current():
    """The innermost active AttrScope (an empty one outside any)."""
    if not hasattr(AttrScope._current, "value"):
        AttrScope._current.value = AttrScope()
    return AttrScope._current.value
