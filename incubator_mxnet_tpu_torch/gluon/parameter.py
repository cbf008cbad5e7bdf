"""Parameter & ParameterDict over ``torch.nn.Parameter`` (counterpart of
``incubator_mxnet_tpu/gluon/parameter.py``).

A ``Parameter`` keeps the MXNet contract — a declared shape that may be
deferred (0 entries) until the first forward, an ``init`` of its own,
``initialize(init, ctx)``, ``data()``, ``grad()``, ``set_data`` and
``cast()`` — and holds its value as one ``nn.Parameter``. The block that
owns it registers that tensor under the attribute name, so
``state_dict()`` and ``named_parameters()`` see it. ``cast`` swaps the
tensor's storage in place, which keeps the registered object (and any
sharing, such as a tied embedding) intact.

``data()`` is an NDArray over the ``nn.Parameter`` itself (the same object
each call), so ``p.data()[:] = v`` writes the parameter. ``grad()`` is an
NDArray over its gradient, which ``autograd.backward`` writes by the
parameter's ``grad_req`` ("write" replaces, "add" adds; a tied weight gets
the sum of its uses within one backward) and ``Trainer.step`` reads. The
package's own layers and the trainer take the tensor through
``_tensor()``. ``lr_mult`` and ``wd_mult`` scale the optimizer's learning
rate and weight decay for this parameter. ``_version`` counts the
rewrites (``set_data``, ``cast``, a re-initialisation), which a
hybridized block's captured graphs compare.
"""
from __future__ import annotations

import logging
import threading

import numpy as onp
import torch

from .. import autograd
from .. import initializer as init_mod
from ..context import as_device, context_of, cpu
from ..ndarray import NDArray, torch_dtype
from ..ndarray.ndarray import _mx_dtype, array as nd_array

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]


#: ``.fn``: a function Parameter -> tensor or None that, on this thread,
#: stands in for parameters' own tensors (``Parameter._tensor``): a
#: position of a data-parallel step reads its device's replica, a pipeline
#: stage the slice of its stacked parameters (``parallel``)
_OVERRIDE = threading.local()


class DeferredInitializationError(Exception):
    """Parameter used before its shape was known."""


class Parameter:
    """A parameter with an MXNet-style (possibly deferred) shape."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        # MXNet's storage types (stype, grad_stype) are accepted; storage
        # stays dense, as in the JAX package
        self._grad_req = grad_req if differentiable else "null"
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
        self._version = 0            # bumped when rewritten or rebound
        #: a ``parallel.P`` over mesh axes (tensor and expert parallel
        #: layers set it); None replicates
        self.sharding = None

    @property
    def shape(self):
        return self._shape

    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be 'write', 'add' or 'null', got "
                             "%r" % (req,))
        self._grad_req = req
        if self._data is not None:
            autograd._mark(self._data, req)

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
            autograd._mark(self._data, self.grad_req)
            for module, attr in self._owners:
                module._parameters[attr] = self._data
        else:
            self._data.data = data
            self._data._mx_grad = None
        self._version += 1
        self._deferred_init = None

    def _finish_deferred_init(self):
        if self._deferred_init is None:
            return
        if not self._shape_known():
            raise DeferredInitializationError(
                "Parameter %s has unknown shape %s" % (self.name, self._shape))
        self._finish_init(*self._deferred_init)

    # ----------------------------------------------------------------
    def _tensor(self):
        """The ``nn.Parameter``: what the package's own code computes on
        (or, inside a ``parallel`` override on this thread, the tensor that
        stands in for it)."""
        fn = getattr(_OVERRIDE, "fn", None)
        if fn is not None:
            t = fn(self)
            if t is not None:
                return t
        if self._data is None:
            if self._deferred_init is not None:
                raise DeferredInitializationError(
                    "Parameter %s was not initialized because it has unknown "
                    "shape %s. Run a forward pass first."
                    % (self.name, self._shape))
            raise RuntimeError("Parameter %s has not been initialized. Call "
                               ".initialize() first." % self.name)
        return self._data

    def data(self, ctx=None):
        """An NDArray over the parameter's tensor (it shares the storage;
        the same object on every call)."""
        t = self._tensor()
        nd = getattr(t, "_mx_nd", None)
        if nd is None or nd._data is not t:
            nd = t._mx_nd = NDArray(t)
        return nd

    def grad(self, ctx=None):
        """An NDArray over the gradient: the last backward's for "write",
        the sum of the backwards for "add", zeros before any."""
        if self.grad_req == "null":
            raise RuntimeError("Parameter %s has grad_req='null'" % self.name)
        return autograd._grad_array(self._tensor())

    @torch.no_grad()
    def zero_grad(self):
        """Set the gradient to zeros, in place."""
        g = getattr(self._data, "_mx_grad", None)
        if g is not None:
            g._data.zero_()

    def list_data(self):
        """[``data()``]: one copy, on one device."""
        return [self.data()]

    def list_grad(self):
        """[``grad()``]."""
        return [self.grad()]

    def list_ctx(self):
        """[the Context this parameter lives on]."""
        return [context_of(self._tensor())]

    @torch.no_grad()
    def reset_ctx(self, ctx):
        """Move this parameter to ``ctx`` (a Context or a list of one), in
        place: the registered tensor keeps its identity and its
        gradient is dropped. A parameter that waits for its shape is
        initialized on ``ctx`` later."""
        if isinstance(ctx, (list, tuple)):
            ctx = ctx[0]
        device = as_device(ctx)
        if self._data is None:
            if self._deferred_init is not None:
                self._deferred_init = self._deferred_init[:2] + (
                    device,) + self._deferred_init[3:]
            return
        self._data.data = self._data.data.to(device)
        self._data._mx_grad = None
        self._version += 1

    def var(self):
        """This parameter as a symbol variable of its name, shape and
        dtype."""
        from ..symbol import var
        return var(self.name, shape=self._shape, dtype=self.dtype)

    @torch.no_grad()
    def set_data(self, data):
        """Copy ``data`` (an NDArray, a tensor or a numpy array) into this
        parameter, in its dtype and on its device. A parameter whose shape
        waits for a forward takes ``data``'s shape and is initialized."""
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.from_numpy(onp.array(data))
        if self._data is None and self._deferred_init is not None:
            self.shape = data.shape
            self._finish_deferred_init()
        self._tensor().copy_(data)
        self._version += 1

    def cast(self, dtype):
        self.dtype = dtype
        if self._data is not None:
            self._data.data = self._data.data.to(torch_dtype(dtype))
            self._data._mx_grad = None
            self._version += 1

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (self.name, self._shape,
                                                     self.dtype)


class _ValueInit(init_mod.Initializer):
    """Fills a parameter with one fixed array (``Constant``'s value)."""

    def __init__(self, value):
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.copy_(self.value)


class Constant(Parameter):
    """A parameter that holds ``value`` (an NDArray, a tensor or anything
    numpy takes) and is never trained: ``grad_req`` "null", and its own
    initializer writes ``value`` (a block's ``initialize`` keeps it,
    whatever default it is given). ``save_parameters`` writes it as any
    parameter, in ``value``'s dtype."""

    def __init__(self, name, value):
        if not isinstance(value, (NDArray, torch.Tensor)):
            value = nd_array(value, ctx=cpu())     # JAX's dtype narrowing
        if isinstance(value, NDArray):
            value = value._data
        self.value = value.detach().cpu()
        super().__init__(name, grad_req="null", shape=tuple(value.shape),
                         dtype=_mx_dtype(value.dtype),
                         init=_ValueInit(self.value))


class ParameterDict:
    """Ordered name → Parameter map. ``prefix`` is MXNet's name prefix (the
    port's keys are structural names, so ``get`` does not prepend it);
    ``shared`` is a dict whose parameters ``get`` returns before it makes
    new ones."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._shared = shared
        self._params = {}

    @property
    def prefix(self):
        return self._prefix

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

    def get(self, name, **kwargs):
        """The parameter ``name``, made with ``kwargs`` if the dict has none
        (MXNet's idiom ``self.weight = self.params.get("weight", ...)``:
        the attribute registers it)."""
        if name not in self._params:
            if self._shared is not None and name in self._shared:
                self._params[name] = self._shared[name]
            else:
                self._params[name] = Parameter(name, **kwargs)
        return self._params[name]

    def get_constant(self, name, value=None):
        """The ``Constant`` ``name``, made from ``value`` if the dict has
        none."""
        if name not in self._params:
            if value is None:
                raise KeyError("No constant named %s" % name)
            self._params[name] = Constant(name, value)
        return self._params[name]

    def update(self, other):
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise ValueError("Cannot update because keys overlap: %s" % k)
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None):
        """Initialize every parameter; ``init`` is the default initializer
        for parameters without one of their own. One generator feeds them
        all, in key order, so a seed fixes the whole model. ``verbose``
        logs each parameter's name and initializer, as MXNet does."""
        init = init_mod.Uniform() if init is None else init_mod.create(init)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, p in self.items():
            p.initialize(None, ctx, init, force_reinit=force_reinit,
                         generator=generator)
            if verbose:
                used = init if p.init is None else init_mod.create(p.init)
                logging.getLogger(__name__).info(
                    "Initialized %s with %s", name, used.dumps())

    def cast(self, dtype):
        for p in self.values():
            p.cast(dtype)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set the attribute ``name`` of every parameter, such as
        ``setattr("grad_req", "null")``."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to ``filename`` (MXNet's ``.params``
        format) under its key with ``strip_prefix`` taken off; a key that
        does not start with it raises."""
        arrays = {}
        for name, p in self.items():
            if not name.startswith(strip_prefix):
                raise ValueError("Prefix %s is to be stripped before saving, "
                                 "but Parameter %s does not start with it"
                                 % (strip_prefix, name))
            arrays[name[len(strip_prefix):]] = p.data()
        from .. import ndarray as nd
        nd.save(filename, arrays)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Copy the arrays of ``filename`` into the parameters of the same
        keys (``restore_prefix`` put before each file name), as
        ``Block.load_parameters`` does."""
        from .. import ndarray as nd
        loaded = {restore_prefix + k: v for k, v in nd.load(filename).items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise AssertionError("Parameter %s missing in file %s"
                                         % (name, filename))
        for name, data in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError("Parameter %s in file is not in "
                                         "this dict" % name)
                continue
            p = self._params[name]
            if p._data is None and p._deferred_init is None:
                p.shape = data.shape
                p.initialize(ctx=ctx)
            p.set_data(data)
