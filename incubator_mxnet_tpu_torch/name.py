"""Automatic operator naming (counterpart of
``incubator_mxnet_tpu/name.py``): ``NameManager`` gives ``hint0``,
``hint1``, ... and ``Prefix`` prepends a prefix to every automatic name."""
from __future__ import annotations

import threading

__all__ = ["NameManager", "Prefix", "current"]


class NameManager:
    _current = threading.local()

    def __init__(self):
        self._counter = {}
        self._old_manager = None

    def get(self, name, hint):
        """``name`` when given, else ``hint`` and its next count."""
        if name:
            return name
        if hint not in self._counter:
            self._counter[hint] = 0
        name = "%s%d" % (hint, self._counter[hint])
        self._counter[hint] += 1
        return name

    def __enter__(self):
        if not hasattr(NameManager._current, "value"):
            NameManager._current.value = NameManager()
        self._old_manager = NameManager._current.value
        NameManager._current.value = self
        return self

    def __exit__(self, *args):
        NameManager._current.value = self._old_manager


class Prefix(NameManager):
    """Prepend ``prefix`` to every automatic name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        name = super().get(name, hint)
        return self._prefix + name


def current():
    """The innermost active NameManager (a default one outside any)."""
    if not hasattr(NameManager._current, "value"):
        NameManager._current.value = NameManager()
    return NameManager._current.value
