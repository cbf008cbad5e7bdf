"""Custom-operator libraries (counterpart of
``incubator_mxnet_tpu/library.py``; ref python/mxnet/library.py
MXLoadLib).

An operator library is a Python module that calls ``register_op`` when it
is imported, as in the JAX package: the reference's dlopen'd C++ ``.so``
maps to an importable plugin module (``load``). ``register_op`` puts the
operator into ``nd`` and ``sym``; with ``gradient=`` it is a
``torch.autograd.Function`` behind ``nd._apply`` (the JAX package's
``custom_vjp``), so ``autograd.record()``/``backward()`` reach it.
"""
from __future__ import annotations

import importlib
import importlib.util
import os

import torch

from . import autograd
from . import ndarray as nd

__all__ = ["load", "register_op", "unregister_op"]

_REGISTERED_OPS = {}   # name -> {module: shadowed attr or _ABSENT}; only
                       # these names may be unregistered (guards builtins)
_ABSENT = object()


def _function(fn, gradient):
    """``fn`` (NDArrays in, an NDArray or a tuple of them out) with the
    custom backward ``gradient(inputs, out_grad) -> input grads`` as a
    ``torch.autograd.Function``."""

    class _Op(torch.autograd.Function):
        @staticmethod
        def forward(ctx, *datas):
            ctx.save_for_backward(*datas)
            with autograd.pause():
                outs = fn(*[nd.NDArray(d) for d in datas])
            if isinstance(outs, nd.NDArray):
                return outs._data
            return tuple(o._data for o in outs)

        @staticmethod
        def backward(ctx, *grads):
            datas = [nd.NDArray(d) for d in ctx.saved_tensors]
            g = nd.NDArray(grads[0]) if len(grads) == 1 else \
                [nd.NDArray(x) for x in grads]
            with autograd.pause():
                got = gradient(datas, g)
            return tuple(x._data for x in got)

    return _Op


def register_op(name, fn, gradient=None):
    """Register a custom operator into ``nd`` (and its ``sym`` mirror).

    ``fn`` operates on NDArrays; ``gradient`` (optional) gives the input
    gradients from the inputs and the output gradient."""
    if gradient is not None:
        apply = _function(fn, gradient).apply

        def op(*args, **kwargs):
            return nd._apply(apply, *args)
    else:
        def op(*args, **kwargs):
            return fn(*args, **kwargs)

    saved = _REGISTERED_OPS.setdefault(name, {})
    saved.setdefault("ndarray", getattr(nd, name, _ABSENT))
    setattr(nd, name, op)
    from . import symbol as sym_mod
    saved.setdefault("symbol", getattr(sym_mod, name, _ABSENT))
    setattr(sym_mod, name, sym_mod._symbolize(op, name))
    return op


def unregister_op(name):
    """Remove a custom operator registered through :func:`register_op`
    from ``nd`` and ``sym``, giving back whatever the name bound before (a
    plugin that shadowed a builtin gives it back). Builtins are refused."""
    if name not in _REGISTERED_OPS:
        raise ValueError(
            "'%s' was not registered via register_op (builtin ops cannot "
            "be unregistered)" % name)
    saved = _REGISTERED_OPS.pop(name)
    for mod_name, prev in saved.items():
        mod = importlib.import_module("." + mod_name, __package__)
        if prev is _ABSENT:
            if hasattr(mod, name):
                delattr(mod, name)
        else:
            setattr(mod, name, prev)


def load(path, verbose=True):
    """Load a plugin: a ``.py`` module calling ``register_op`` when it is
    imported (ref library.py load / MXLoadLib)."""
    if not os.path.exists(path):
        raise ValueError("library %s not found" % path)
    if path.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.basename(path)[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    raise ValueError("unsupported library type %s (use a .py plugin module; "
                     "C extensions load via normal python import)" % path)
