"""Typed exceptions (counterpart of ``incubator_mxnet_tpu/error.py``).

MXNet maps C++ error prefixes onto Python exception types through
``register``; here errors come from Python and PyTorch, so the hierarchy
is kept for API parity and for user code that catches the typed classes.
"""
from __future__ import annotations

from .base import MXNetError

__all__ = ["MXNetError", "InternalError", "ValueError", "TypeError",
           "IndexError", "NotImplementedForSymbol", "register"]

_ERROR_REGISTRY = {}


def register(name_or_cls):
    """Map an error-prefix name to a class: ``@register`` registers the
    class under its own name, ``@register("Name")`` under ``Name``."""
    def do_register(cls, name):
        _ERROR_REGISTRY[name] = cls
        return cls
    if isinstance(name_or_cls, str):
        return lambda cls: do_register(cls, name_or_cls)
    return do_register(name_or_cls, name_or_cls.__name__)


@register
class InternalError(MXNetError):
    """A framework-internal invariant was violated."""


@register
class ValueError(MXNetError, ValueError):  # noqa: A001 — MXNet shadows it
    pass


@register
class TypeError(MXNetError, TypeError):  # noqa: A001
    pass


@register
class IndexError(MXNetError, IndexError):  # noqa: A001
    pass


class NotImplementedForSymbol(MXNetError):
    """An ``nd``-only function called on a Symbol."""

    def __init__(self, function, alias=None, *args):
        super().__init__()
        self.function = function.__name__ if callable(function) else function

    def __str__(self):
        return "Function %s is not implemented for Symbol." % self.function
