"""Block / HybridBlock as ``torch.nn.Module`` subclasses (counterpart of
``incubator_mxnet_tpu/gluon/block.py``).

A child block assigned as an attribute, or given to ``register_child``, is
an ``nn.Module`` child under that name; a ``gluon.Parameter`` assigned as an
attribute is registered as an ``nn.Parameter`` under that name. So
``state_dict()`` keys are the JAX package's structural parameter names
(``Block._collect_params_with_prefix``), for example
``encoder.layer0.attention_cell.query.weight``. ``collect_params()`` is
keyed by the same names.

Blocks take MXNet's ``prefix=`` keyword and offer ``name_scope()``, which
model code such as the model zoo uses; the structural names above do not
depend on either, so the prefix is accepted and not used, and
``name_scope()`` opens an empty scope. Sharing parameters through
``params=`` is not ported yet and raises.

Calling a block with NDArray arguments unwraps them once, runs the
forward on tensors (recorded for ``autograd.backward`` only inside
``autograd.record()``) and wraps the outputs; called with tensors it
returns tensors, so no layer inside wraps anything. ``save_parameters``
and ``load_parameters`` write and read MXNet's ``.params`` format
(``nd.save``/``nd.load``) keyed by the structural names, the files the
JAX package writes and reads.

Train/predict behaviour (dropout, batch norm) follows ``autograd``'s
thread-local training flag, as in the JAX package, not
``nn.Module.training``. ``HybridBlock.hybridize()`` captures the calls of a
block on the card into CUDA graphs, one per signature
(``gluon/_functional.py``); on the CPU it changes nothing.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import torch

from .. import ndarray as nd
from . import _functional
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock"]


class Block(torch.nn.Module):
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        if params is not None:
            raise NotImplementedError("sharing parameters through params= is "
                                      "not ported yet")
        self._reg_params = {}
        self.training = False

    def __call__(self, *args, **kwargs):
        return nd.ndarray._apply(super().__call__, *args, **kwargs)

    def name_scope(self):
        """A scope for creating children, as in MXNet; names here are
        structural, so it changes nothing."""
        return contextlib.nullcontext(self)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            self.__dict__["_reg_params"][name] = value
            value._attach(self, name)
            return
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def register_child(self, block, name=None):
        self.add_module(name or str(len(self._modules)), block)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def collect_params(self):
        """Every parameter of this block and its children, keyed by
        structural name."""
        ret = ParameterDict()
        ret.update(self._collect_params_with_prefix())
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Allocate every parameter on ``ctx`` (default: the current
        context), drawing from ``generator``."""
        self.collect_params().initialize(init, ctx, force_reinit=force_reinit,
                                         generator=generator)

    def save_parameters(self, filename, deduplicate=False):
        """Write every parameter, keyed by structural name, to ``filename``
        in MXNet's ``.params`` format. A parameter shared under two names
        is written under each (``deduplicate`` is accepted and changes
        nothing, as in the JAX package)."""
        params = self._collect_params_with_prefix()
        nd.save(filename, {k: p.data() for k, p in params.items()})

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current"):
        """Copy the arrays of a ``.params`` file into the parameters of the
        same structural names, each in the parameter's dtype and on its
        device; a parameter not yet initialized is initialized on ``ctx``
        (its shape taken from the file). Every parameter must be in the
        file unless ``allow_missing``; every name in the file must be a
        parameter unless ``ignore_extra``. The loaded values take the
        parameter's dtype, as ``cast_dtype`` with ``dtype_source="current"``
        does in MXNet; taking the file's dtype ("saved") is not ported."""
        if cast_dtype and dtype_source != "current":
            raise NotImplementedError("load_parameters with dtype_source=%r "
                                      "is not ported" % (dtype_source,))
        loaded = nd.load(filename)
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise AssertionError("Parameter %s missing in %s"
                                         % (name, filename))
        for name, data in loaded.items():
            if name not in params:
                if not ignore_extra:
                    raise AssertionError("Parameter %s in file not found in "
                                         "Block" % name)
                continue
            p = params[name]
            if p._data is None and p._deferred_init is None:
                p.shape = data.shape
                p.initialize(ctx=ctx)
            p.set_data(data)

    def cast(self, dtype):
        """Cast every child (each by its own ``cast``, so a BatchNorm keeps
        fp32 statistics), then this block's own parameters."""
        for child in self._modules.values():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._reg_params.values():
            p.cast(dtype)
        return self


class HybridBlock(Block):
    """A block whose forward can be captured: ``hybridize()`` makes calls
    on the card replay one CUDA graph per signature (plus one of its
    backward under ``autograd.record()``); on the CPU the forward runs
    eagerly as before (``gluon/_functional.py``)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix, params)
        self._active = False
        self._graphs = collections.OrderedDict()
        self._captures = 0

    def hybridize(self, active=True, **kwargs):
        """Capture this block's calls on the card from now on (``active``),
        or run them eagerly again. MXNet's CachedOp flags
        (``static_alloc``, ``static_shape``) are accepted: a CUDA graph
        holds its memory and shapes anyway. Any earlier captures go."""
        self._active = active
        self._graphs.clear()

    def __call__(self, *args, **kwargs):
        if not self._active or _functional.in_plain():
            return super().__call__(*args, **kwargs)
        return nd.ndarray._apply(functools.partial(_functional.call, self),
                                 *args, **kwargs)

    def export(self, path, epoch=0, example_inputs=None):
        raise NotImplementedError("HybridBlock.export comes with the port "
                                  "of serving's exported artifacts")
