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
model code such as the model zoo uses. They name themselves as MXNet does
(``Block.prefix`` ``dense0_``, ``Block.name`` ``dense0``: a counter per
class name, process-wide, or per parent inside its ``name_scope()``, the
prefix then the parent's plus the child's); the structural names above do
not depend on either, so ``collect_params()`` keys stay structural.

MXNet's central idiom runs as it does there: a ``HybridBlock`` subclass
that defines ``hybrid_forward(self, F, x, ..., **params)`` and no
``forward`` is called with ``F`` the ``nd`` namespace, its arguments as
NDArrays and this block's own parameters as NDArray keywords (by
attribute name); NDArray operations inside record exactly when the call
does, so it holds eagerly, hybridized and inside ``jit.TrainStep``. A
parameter whose shape waits for the first input is inferred by the
block's ``_infer_param_shapes(*args)``, which such a block overrides.

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
import functools
import re
import threading

import torch

from .. import autograd
from .. import ndarray as nd
from . import _functional
from .parameter import DeferredInitializationError, Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "HookHandle", "SymbolBlock"]


class HookHandle:
    """A registered forward hook: ``detach()`` (or ``remove()``) takes it
    off; as a context manager it detaches on exit."""

    def __init__(self, hooks_list, hook):
        self._hooks = hooks_list
        self._hook = hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)

    remove = detach

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.detach()


class _BlockScope:
    """MXNet's naming scope of a block (reference ``gluon/block.py``
    ``_BlockScope``): inside ``with block.name_scope():`` a new block is
    named ``block.prefix + hint + count``, with a count per class name
    kept by that block; outside any scope by a process-wide count."""

    _current = threading.local()
    _counters = {}
    _lock = threading.Lock()

    def __init__(self, block):
        self._block = block
        self._old = None

    @staticmethod
    def prefix(prefix, hint):
        """The prefix of a block of class name ``hint`` made now."""
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                with _BlockScope._lock:
                    count = _BlockScope._counters.get(hint, 0)
                    _BlockScope._counters[hint] = count + 1
                prefix = "%s%d_" % (hint, count)
            return prefix
        if prefix is None:
            counts = current._block._child_counts
            count = counts.get(hint, 0)
            counts[hint] = count + 1
            prefix = "%s%d_" % (hint, count)
        return current._block.prefix + prefix

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
            _BlockScope._current.value = self._old


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
        self._empty_prefix = prefix == ""
        self._prefix = _BlockScope.prefix(prefix, type(self).__name__.lower())
        self._child_counts = {}
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
    def prefix(self):
        """MXNet's name prefix of this block, such as ``dense0_``."""
        return self._prefix

    @property
    def name(self):
        """The prefix without its trailing underscore, such as ``dense0``."""
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self):
        """This block's own parameters (not its children's), by attribute
        name: what another block's ``params=`` takes to share them."""
        ret = ParameterDict(self._prefix)
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
        """MXNet's scope for creating children: a block made inside it is
        named after this block (``prefix``); structural names do not
        change."""
        return _BlockScope(self)

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

    def summary(self, *inputs):
        """Print MXNet's summary table of a call on ``inputs``: this
        block's name and its output's shape (the JAX package's one
        line)."""
        out = self(*inputs)
        print("\n".join(["-" * 64, "%-30s %20s" % ("Layer (type)",
                                                     "Output Shape"),
                         "=" * 64, "%-30s %20s" % (
                             self.name, getattr(out, "shape", "?"))]))

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

    def infer_shape(self, *args):
        """Finish the deferred shapes of this block's parameters from
        ``args`` by one forward that records nothing, as MXNet's."""
        with autograd.pause(train_mode=autograd.is_training()):
            nd.ndarray._apply(self.forward, *args)

    def forward(self, *args):
        """MXNet's ``hybrid_forward(F, *args, **params)`` adapter: ``F``
        is ``nd``, the arguments and this block's own parameters come as
        NDArrays, and the NDArray operations inside record exactly when
        torch's grad mode says this call records (``record()``,
        ``TrainStep``, a captured backward). Returns tensors."""
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise NotImplementedError(
                "%s must implement forward or hybrid_forward"
                % type(self).__name__)
        deferred = [p for p in self._reg_params.values()
                    if p._data is None and p._deferred_init is not None]
        if deferred:
            self._infer_param_shapes(*nd.ndarray._as_ndarrays(args))
            for p in deferred:
                p._finish_deferred_init()
        params = {name: nd.NDArray(p._tensor())
                  for name, p in self._reg_params.items()}
        with autograd._Scope(torch.is_grad_enabled(), None):
            out = self.hybrid_forward(nd, *nd.ndarray._as_ndarrays(args),
                                      **params)
        return _tensors_of(out)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def _infer_param_shapes(self, *args):
        """Set the deferred parameter shapes from the first call's
        arguments (NDArrays): a block with such parameters and a
        ``hybrid_forward`` overrides this."""
        raise DeferredInitializationError(
            "%s has uninitialized parameters and no shape inference; "
            "initialize with known in_units/in_channels" % type(self).__name__)

    _last_input_avals = None    # (shape, dtype) of the last call's inputs

    def __call__(self, *args, **kwargs):
        self._last_input_avals = [(tuple(a.shape), _torch_dtype_of(a))
                                  for a in args if hasattr(a, "shape")]
        if not self._active or _functional.in_plain():
            return super().__call__(*args, **kwargs)
        call = functools.partial(nd.ndarray._apply,
                                 functools.partial(_functional.call, self))
        if self._mx_pre_hooks or self._mx_hooks:
            return self._hooked(args, kwargs, call)
        return call(*args, **kwargs)

    def export(self, path, epoch=0, example_inputs=None):
        """Export for deployment (MXNet's ``HybridBlock.export``): the
        parameters to ``<path>-NNNN.params`` (``arg:`` keys), a manifest
        ``<path>-symbol.json`` (format ``incubator_mxnet_tpu.hybrid``, as
        the JAX package writes it) and, when the input signature is known
        (``example_inputs``, or the shapes of the block's last call), the
        serving artifact ``<path>.mxtpu`` (``contrib.serving``: the
        forward exported by ``torch.export``, parameters baked in).
        ``SymbolBlock.imports`` of the manifest loads the artifact back as
        an inference block."""
        import json
        import os
        params = self._collect_params_with_prefix()
        nd.save("%s-%04d.params" % (path, epoch),
                {("arg:" + k): v.data() for k, v in params.items()})
        inputs = example_inputs
        if inputs is None and self._last_input_avals is not None:
            from ..jit import net_device
            device = net_device(self)
            inputs = [torch.zeros(shape, dtype=dtype, device=device)
                      for shape, dtype in self._last_input_avals]
        artifact = None
        if inputs is not None:
            from ..contrib import serving
            artifact = "%s.mxtpu" % path
            serving.export_model(self, inputs, artifact)
        with open("%s-symbol.json" % path, "w") as f:
            json.dump({"format": "incubator_mxnet_tpu.hybrid",
                       "class": type(self).__name__,
                       "artifact": artifact and os.path.basename(artifact)},
                      f)


def _torch_dtype_of(a):
    return (a._data if isinstance(a, nd.NDArray) else
            a if isinstance(a, torch.Tensor) else torch.as_tensor(a)).dtype


def _tensors_of(tree):
    """``tree`` (tuples and lists, nested) with every NDArray its tensor."""
    if isinstance(tree, nd.NDArray):
        return tree._data
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors_of(t) for t in tree)
    return tree


class SymbolBlock(HybridBlock):
    """A block over a Symbol graph: ``outputs`` (a Symbol, or a list of
    them) computed from ``inputs`` (variables). Every other variable of the
    graph is a parameter of the block under its own name (the structural
    name too); the auxiliary states (BatchNorm's moving statistics) have
    grad_req "null". Shapes not known wait for the first call, which infers
    them from the inputs' (``symbol._infer``)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from ..symbol import Group
        if isinstance(outputs, (list, tuple)):
            outputs = outputs[0] if len(outputs) == 1 else Group(outputs)
        self._sym = outputs
        self._inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
            else [inputs]
        input_names = {i.name for i in self._inputs}
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name not in input_names:
                setattr(self, name, Parameter(
                    name, grad_req="null" if name in aux else "write",
                    allow_deferred_init=True))

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock over a ``-symbol.json`` file, its parameters loaded
        from ``param_file`` (a checkpoint's ``.params``: ``arg:``/``aux:``
        keys) on ``ctx`` (default: the current context). A
        ``HybridBlock.export`` manifest loads its ``.mxtpu`` artifact as
        an inference-only block (``_ServedBlock``: the parameters are
        baked into the program)."""
        import json
        import os
        from .. import symbol as mxsym
        with open(symbol_file) as f:
            text = f.read()
        meta = json.loads(text)
        if isinstance(meta, dict) and \
                meta.get("format") == "incubator_mxnet_tpu.hybrid":
            artifact = meta.get("artifact")
            if not artifact:
                raise ValueError(
                    "%s is a hybrid-export manifest without a serving "
                    "artifact; export again after a forward (or with "
                    "example_inputs) so the .mxtpu program is written"
                    % symbol_file)
            return _ServedBlock(os.path.join(
                os.path.dirname(os.path.abspath(symbol_file)), artifact))
        sym = mxsym.load_json(text)
        if isinstance(input_names, str):
            input_names = [input_names]
        name_to_var = {v.name: v for v in sym.get_internals() if v.is_var}
        block = SymbolBlock(sym, [name_to_var[n] for n in input_names])
        if param_file is not None:
            loaded = {k.split(":", 1)[-1]: v
                      for k, v in nd.load(param_file).items()}
            own = set(block._reg_params)
            extra, missing = set(loaded) - own, own - set(loaded)
            if extra or missing:
                raise AssertionError(
                    "params file does not match the graph: missing %s, "
                    "extra %s" % (sorted(missing), sorted(extra)))
            for name, v in loaded.items():
                p = block._reg_params[name]
                p.shape = tuple(v.shape)
                p.initialize(init="zeros", ctx=ctx, force_reinit=True)
                p.set_data(v)
        return block

    def _infer_param_shapes(self, *args):
        from ..symbol.symbol import _infer
        shapes = {i.name: tuple(a.shape) for i, a in zip(self._inputs, args)}
        for name, p in self._reg_params.items():
            if p._data is not None:
                shapes[name] = tuple(p.shape)
        got = _infer(self._sym, shapes)
        if got is None:
            raise DeferredInitializationError(
                "SymbolBlock cannot infer its parameters' shapes from "
                "inputs of shapes %s" % [tuple(a.shape) for a in args])
        for name, p in self._reg_params.items():
            if p._data is None:
                p.shape = got[0][name]

    def hybrid_forward(self, F, *args, **params):
        bindings = {i.name: a for i, a in zip(self._inputs, args)}
        bindings.update(params)
        return self._sym.eval_imperative(bindings)


class _ServedBlock(Block):
    """``SymbolBlock.imports`` of a hybrid-export manifest: the ``.mxtpu``
    serving artifact (``contrib.serving.ServedModel``, parameters baked
    in) as an inference-only block."""

    def __init__(self, artifact_path):
        super().__init__(prefix="", params=None)
        from ..contrib import serving
        self._served = serving.load(artifact_path)
        self._artifact_path = artifact_path

    def forward(self, *args):
        return self._served.predict(*args)
