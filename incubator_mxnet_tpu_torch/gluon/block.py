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
``name_scope()`` opens an empty scope.

``params=`` shares parameters: given another block's ``params`` (its own
parameters) or ``collect_params()`` (its whole tree), a parameter this
block (or a child, at any depth) registers under a structural name found
there is that one ``Parameter`` object. A shared parameter has one
structural name in each block that holds it: ``save_parameters`` writes
it under each, as the JAX package does, and ``collect_params()`` lists it
once (under its first name), so a ``Trainer`` updates it once with the sum
of its uses' gradients.

``register_forward_pre_hook(hook)`` and ``register_forward_hook(hook)``
are MXNet's: ``hook(block, args)`` before and ``hook(block, args, out)``
after every call, ``args`` as the caller passed them (NDArrays stay
NDArrays), return values ignored; each returns a ``HookHandle`` (its
``detach()``, or torch's name ``remove()``, unregisters it). They
override ``nn.Module``'s methods of the same names; torch's own module
hooks stay reachable as ``torch.nn.Module.register_forward_hook(block,
...)`` and run inside the call, on tensors. A hybridized block runs its
own hooks at every call; its children's run where their forward runs: at
a signature's eager call and its capture, not at replays (the JAX
package runs them when it traces). ``apply(fn)`` is ``nn.Module``'s:
``fn`` on every child, depth first, then on the block.

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
import re

import torch

from .. import ndarray as nd
from . import _functional
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "HookHandle", "SymbolBlock"]


class HookHandle:
    """A registered forward hook: ``detach()`` (or ``remove()``) takes it
    off; as a context manager it detaches on exit."""

    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._hook = hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)

    remove = detach

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


def _under(shared, name):
    """The entries of ``shared`` below the structural name ``name``."""
    head = name + "."
    return {k[len(head):]: v for k, v in shared.items() if k.startswith(head)}


def _adopt(shared, declared):
    """``shared`` in place of the parameter ``declared``: its shape takes
    what ``declared`` knows (0 is unknown); a conflict raises."""
    if shared.shape is not None and declared.shape is not None:
        shared.shape = tuple(d if d else s for s, d in
                             zip(shared.shape, declared.shape)) \
            if len(shared.shape) == len(declared.shape) else declared.shape
    return shared


class Block(torch.nn.Module):
    """Base building block."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        self._reg_params = {}
        self._shared = None if params is None else dict(params.items())
        self._mx_pre_hooks = []
        self._mx_hooks = []
        self.training = False

    def __call__(self, *args, **kwargs):
        if self._mx_pre_hooks or self._mx_hooks:
            return self._hooked(args, kwargs, functools.partial(
                nd.ndarray._apply, super().__call__))
        return nd.ndarray._apply(super().__call__, *args, **kwargs)

    def _hooked(self, args, kwargs, call):
        """``call(*args, **kwargs)`` between this block's MXNet hooks, which
        see arrays as NDArrays (a child inside a forward is called with
        tensors; the hook gets NDArrays over them, as MXNet's would)."""
        if self._mx_pre_hooks:
            shown = nd.ndarray._as_ndarrays(args)
            for hook in list(self._mx_pre_hooks):
                hook(self, shown)
        out = call(*args, **kwargs)
        if self._mx_hooks:
            shown = nd.ndarray._as_ndarrays(args)
            for hook in list(self._mx_hooks):
                hook(self, shown, nd.ndarray._as_ndarrays(out))
        return out

    def register_forward_pre_hook(self, hook):
        """Run ``hook(block, args)`` before every call of this block."""
        self._mx_pre_hooks.append(hook)
        return HookHandle(self._mx_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """Run ``hook(block, args, out)`` after every call of this block."""
        self._mx_hooks.append(hook)
        return HookHandle(self._mx_hooks, hook)

    @property
    def params(self):
        """This block's own parameters (not its children's), by attribute
        name: what another block's ``params=`` takes to share them."""
        ret = ParameterDict()
        ret.update(self._reg_params)
        return ret

    def _share(self, shared):
        """Take the parameters of ``shared`` (structural name → Parameter,
        relative to this block) in place of this block's own and its
        children's of the same names, now and for parameters and children
        registered later."""
        if not shared:
            return
        self._shared = {**shared, **(self._shared or {})}
        for name, p in list(self._reg_params.items()):
            if name in shared and shared[name] is not p:
                setattr(self, name, p)   # __setattr__ puts shared[name] in
        for name, child in self._modules.items():
            if isinstance(child, Block):
                child._share(_under(self._shared, name))

    def name_scope(self):
        """A scope for creating children, as in MXNet; names here are
        structural, so it changes nothing."""
        return contextlib.nullcontext(self)

    def __setattr__(self, name, value):
        shared = self.__dict__.get("_shared")
        if isinstance(value, Parameter):
            if shared and name in shared:
                value = _adopt(shared[name], value)
            self.__dict__["_reg_params"][name] = value
            value._attach(self, name)
            return
        if shared and isinstance(value, Block):
            value._share(_under(shared, name))
        super().__setattr__(name, value)

    def __getattr__(self, name):
        reg = self.__dict__.get("_reg_params")
        if reg is not None and name in reg:
            return reg[name]
        return super().__getattr__(name)

    def register_child(self, block, name=None):
        name = name or str(len(self._modules))
        if self._shared and isinstance(block, Block):
            block._share(_under(self._shared, name))
        self.add_module(name, block)

    def _collect_params_with_prefix(self, prefix=""):
        if prefix:
            prefix += "."
        ret = {prefix + k: v for k, v in self._reg_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def collect_params(self, select=None):
        """Every parameter of this block and its children, keyed by
        structural name, each once (a shared parameter under its first
        name); with ``select``, those whose name the regular expression
        matches."""
        pattern = re.compile(select) if select else None
        seen, ret = set(), ParameterDict()
        for name, p in self._collect_params_with_prefix().items():
            if id(p) not in seen and (pattern is None or pattern.match(name)):
                seen.add(id(p))
                ret.update({name: p})
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
        call = functools.partial(nd.ndarray._apply,
                                 functools.partial(_functional.call, self))
        if self._mx_pre_hooks or self._mx_hooks:
            return self._hooked(args, kwargs, call)
        return call(*args, **kwargs)

    def export(self, path, epoch=0, example_inputs=None):
        raise NotImplementedError("HybridBlock.export comes with the port "
                                  "of serving's exported artifacts "
                                  "(ROADMAP.md §1 item 8)")


class SymbolBlock(HybridBlock):
    """A block over a Symbol graph: waits for the port of ``symbol/``
    (ROADMAP.md §1 item 7), so building one or ``imports`` raises."""

    def __init__(self, outputs, inputs, params=None):
        raise NotImplementedError("SymbolBlock comes with the port of "
                                  "symbol/ (ROADMAP.md §1 item 7)")

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        raise NotImplementedError("SymbolBlock.imports comes with the port "
                                  "of symbol/ (ROADMAP.md §1 item 7)")
