"""Symbol: the lazy graph API (counterpart of
``incubator_mxnet_tpu/symbol/symbol.py``).

A Symbol is an expression DAG over the port's ``nd`` operators, as in the
JAX package: a node holds the ``nd`` function, its input symbols and its
keywords; ``eval_imperative`` runs the DAG on NDArrays, and ``bind`` /
``simple_bind`` give an ``Executor`` that runs it on one device through the
port's autograd. Nothing is compiled or captured: the Module runs eagerly,
as the reference's does.

Shapes are inferred by running the DAG on ``torch.device("meta")`` tensors
(``_infer``), which allocates nothing; the parameter variables that a layer
op creates (``FullyConnected``'s ``fc_weight``, ...) carry a rule that
gives their shape from the data's. An op that cannot run on meta tensors
(one that reads a value on the host) is run on zeros instead.

MXNet's split of the inputs, not the JAX package's: BatchNorm's
``moving_mean``/``moving_var`` are auxiliary states
(``list_auxiliary_states``), not arguments; ``list_inputs`` gives both, in
the order the JAX package's ``list_arguments`` gives them.

``tojson``/``load_json`` write and read the JAX package's graph file
byte for byte (its ``"format"`` tag, attributes written with ``str()`` and
read back with ``literal_eval``), so a ``-symbol.json`` written by either
package loads in the other.
"""
from __future__ import annotations

import json

import numpy as onp
import torch

from .. import autograd
from .. import ndarray as nd
from ..context import cpu
from ..ndarray import NDArray

__all__ = ["Symbol", "var", "Variable", "Group", "load", "load_json", "zeros",
           "ones"]

_META = torch.device("meta")


class Symbol:
    def __init__(self, op=None, op_name="", inputs=None, kwargs=None, name=None,
                 num_outputs=1, output_index=None):
        self._op = op                     # callable on NDArrays (an nd function)
        self._op_name = op_name
        self._inputs = inputs or []       # list[Symbol]
        self._kwargs = kwargs or {}
        self._attr = {}
        self.name = name or _auto_name(op_name or "sym")
        self._num_outputs = num_outputs
        self._output_index = output_index  # not None: one output of a node

    # ---------------------------------------------------------------- graph
    @property
    def is_var(self):
        return self._op is None and not self._inputs

    def _walk(self):
        """Every node reachable from this one, inputs first (DFS)."""
        return _postorder([self])

    def _var_names(self, aux):
        order = []
        for s in self._walk():
            if s.is_var and s.name not in order and \
                    bool(getattr(s, "_is_aux", False)) == aux:
                order.append(s.name)
        return order

    def list_inputs(self):
        """Arguments and auxiliary states, in DFS order."""
        order = []
        for s in self._walk():
            if s.is_var and s.name not in order:
                order.append(s.name)
        return order

    def list_arguments(self):
        """Free variables in DFS order, the auxiliary states left out."""
        return self._var_names(aux=False)

    def list_outputs(self):
        if self._num_outputs == 1 or self._output_index is not None:
            return [self.name + "_output"]
        return ["%s_output%d" % (self.name, i) for i in range(self._num_outputs)]

    def list_auxiliary_states(self):
        """The states an op updates in place and no gradient reaches
        (BatchNorm's ``moving_mean``, ``moving_var``), in DFS order."""
        return self._var_names(aux=True)

    def get_internals(self):
        """All nodes as a Group."""
        return Group(self._walk())

    def attr(self, key):
        return self._attr.get(key)

    def _set_attr(self, **kwargs):
        self._attr.update(kwargs)

    def attr_dict(self):
        """{node_name: {attr: str}} over the whole DAG."""
        out = {}
        for s in self.get_internals():
            if s._attr:
                out.setdefault(s.name, {}).update(
                    {k: str(v) for k, v in s._attr.items()})
        return out

    def __getitem__(self, index):
        if isinstance(index, int):
            if self._num_outputs == 1:
                assert index == 0
                return self
            # memoized views sharing _base, so that eval_imperative runs
            # the producing op once for all the outputs consumed
            views = self.__dict__.setdefault("_views", {})
            if index not in views:
                v = Symbol(op=self._op, op_name=self._op_name, inputs=self._inputs,
                           kwargs=self._kwargs, name=self.name,
                           num_outputs=self._num_outputs, output_index=index)
                v._base = self._base if self._output_index is not None else self
                views[index] = v
            return views[index]
        raise TypeError("symbol index must be int")

    def __iter__(self):
        return iter([self[i] for i in range(self._num_outputs)])

    # ---------------------------------------------------------------- eval
    def eval_imperative(self, bindings, _cache=None):
        """Evaluate the DAG with NDArray bindings {name: NDArray}."""
        return _evaluate([self], bindings, _cache)[0]

    def eval(self, ctx=None, **kwargs):
        """The outputs as a list of NDArrays."""
        out = self.eval_imperative(kwargs)
        return out if isinstance(out, (list, tuple)) else [out]

    # ---------------------------------------------------------------- shapes
    def infer_shape(self, **kwargs):
        """(argument shapes, output shapes, auxiliary-state shapes) from
        the shapes given, by running the DAG on meta tensors. The shapes of
        the parameter variables a layer op made are inferred from its data,
        as MXNet does (the JAX package needs every argument's shape and
        otherwise returns Nones); with any other variable unknown it
        returns ``(None, None, None)``."""
        got = _infer(self, {k: tuple(v) for k, v in kwargs.items()})
        if got is None:
            return None, None, None
        shapes, outs = got
        return ([shapes[n] for n in self.list_arguments()],
                [tuple(o.shape) for o in outs],
                [shapes[n] for n in self.list_auxiliary_states()])

    def infer_type(self, **kwargs):
        return ([onp.float32] * len(self.list_arguments()),
                [onp.float32] * len(self.list_outputs()),
                [onp.float32] * len(self.list_auxiliary_states()))

    # ---------------------------------------------------------------- bind
    def simple_bind(self, ctx=None, grad_req="write", **shapes):
        """An Executor with zero arrays of ``shapes`` on ``ctx`` (default:
        the current context); the parameter variables of layer ops take
        their inferred shapes."""
        from ..context import as_device
        from ..executor import Executor

        device = as_device(ctx)
        by_name = {s.name: s for s in self._walk() if s.is_var}
        args = {}
        for name in self.list_inputs():
            v = by_name.get(name)
            if name in shapes:
                args[name] = NDArray(torch.zeros(_shape(shapes[name]),
                                                 device=device))
            elif v is not None and getattr(v, "_deferred_shape_fn", None):
                continue  # made by the Executor from the data's shape
            else:
                raise ValueError("simple_bind needs shape for %r" % name)
        return Executor(self, ctx, args, grad_req=grad_req)

    def bind(self, ctx=None, args=None, args_grad=None, grad_req="write",
             aux_states=None, **kwargs):
        """An Executor over the given arrays (a dict, or a list in
        ``list_arguments`` order; ``aux_states`` likewise)."""
        from ..executor import Executor

        names = self.list_arguments()
        if isinstance(args, (list, tuple)):
            args = dict(zip(names, args))
        if isinstance(args_grad, (list, tuple)):
            args_grad = dict(zip(names, args_grad))
        if isinstance(aux_states, (list, tuple)):
            aux_states = dict(zip(self.list_auxiliary_states(), aux_states))
        return Executor(self, ctx, args, args_grad=args_grad,
                        grad_req=grad_req, aux_states=aux_states)

    # ---------------------------------------------------------------- misc ops
    def _binop(self, other, fn, op_name, reverse=False):
        if isinstance(other, Symbol):
            ins = [other, self] if reverse else [self, other]
            return Symbol(op=fn, op_name=op_name, inputs=ins)
        # a scalar operand stays in kwargs, so that tojson/load_json
        # round-trip it (MXNet's _plus_scalar family)
        return Symbol(op=_scalar_binop_fn(fn), op_name=op_name + "_scalar",
                      inputs=[self],
                      kwargs={"scalar": other, "reverse": bool(reverse)})

    def __add__(self, o): return self._binop(o, nd.add, "_plus")
    def __radd__(self, o): return self._binop(o, nd.add, "_plus", True)
    def __sub__(self, o): return self._binop(o, nd.subtract, "_minus")
    def __rsub__(self, o): return self._binop(o, nd.subtract, "_minus", True)
    def __mul__(self, o): return self._binop(o, nd.multiply, "_mul")
    def __rmul__(self, o): return self._binop(o, nd.multiply, "_mul", True)
    def __truediv__(self, o): return self._binop(o, nd.divide, "_div")
    def __rtruediv__(self, o): return self._binop(o, nd.divide, "_div", True)
    def __pow__(self, o): return self._binop(o, nd.power, "_pow")
    # comparisons build nodes; __eq__/__hash__ stay identity-based so that
    # symbols remain dict keys
    def __gt__(self, o): return self._binop(o, nd.greater, "_greater")
    def __ge__(self, o): return self._binop(o, nd.greater_equal, "_greater_equal")
    def __lt__(self, o): return self._binop(o, nd.lesser, "_lesser")
    def __le__(self, o): return self._binop(o, nd.lesser_equal, "_lesser_equal")
    def __mod__(self, o): return self._binop(o, nd.modulo, "_mod")
    def __neg__(self):
        return Symbol(op=nd.negative, op_name="negative", inputs=[self])

    def __repr__(self):
        return "<Symbol %s>" % self.name

    # ---------------------------------------------------------------- io
    def optimize_for(self, backend, args=None, ctx=None, **kwargs):
        """This graph partitioned for a registered subgraph backend
        (``subgraph.partition``; ref symbol.optimize_for)."""
        from ..subgraph import partition
        return partition(self, backend)

    def get_backend_symbol(self, backend):
        """The legacy name of ``optimize_for``."""
        return self.optimize_for(backend)

    def tojson(self):
        """The graph JSON (structural: ops are named, not serialized)."""
        nodes, index = [], {}

        def visit(s):
            if id(s) in index:
                return index[id(s)]
            inputs = [visit(i) for i in s._inputs]
            idx = len(nodes)
            nodes.append({
                "op": "null" if s.is_var else s._op_name,
                "name": s.name,
                "inputs": [[i, 0, 0] for i in inputs],
                "attrs": {k: str(v) for k, v in s._kwargs.items()},
            })
            index[id(s)] = idx
            return idx

        visit(self)
        return json.dumps({"nodes": nodes, "format": "incubator_mxnet_tpu.symbol",
                           "heads": [[len(nodes) - 1, 0, 0]]}, indent=2)

    def save(self, fname):
        with open(fname, "w") as f:
            f.write(self.tojson())


class Group(Symbol):
    """Several outputs grouped."""

    def __init__(self, symbols):
        super().__init__(op_name="_group", name=_auto_name("group"))
        self._symbols = list(symbols)
        # the children double as graph inputs, so that DAG walks reach them;
        # eval_imperative is overridden, so the missing _op never runs
        self._inputs = list(symbols)
        self._num_outputs = len(self._symbols)

    def eval_imperative(self, bindings, _cache=None):
        return _evaluate(self._symbols, bindings, _cache)

    def list_outputs(self):
        return sum((s.list_outputs() for s in self._symbols), [])

    def __getitem__(self, i):
        return self._symbols[i]


def _postorder(roots):
    """The nodes reachable from ``roots``, each after its inputs and once
    (depth-first, inputs in order; iterative, so a deep graph does not
    reach Python's recursion limit)."""
    seen, order = set(), []
    stack = [(r, False) for r in reversed(roots)]
    while stack:
        s, done = stack.pop()
        if done:
            order.append(s)
            continue
        if id(s) in seen:
            continue
        seen.add(id(s))
        stack.append((s, True))
        stack.extend((i, False) for i in reversed(s._inputs)
                     if id(i) not in seen)
    return order


def _key(s):
    """The cache key of a node: its producing node and output index."""
    return (id(getattr(s, "_base", None) or s), s._output_index)


def _evaluate(roots, bindings, cache=None):
    """The values of ``roots`` with the variables bound to ``bindings``.
    Each node runs once. With a cache of its own (``cache`` None) a value
    is dropped as soon as its last consumer has run, so a training forward
    keeps only what autograd saves, not every intermediate array."""
    free = cache is None
    cache = {} if free else cache
    order = [s for s in _postorder(roots) if not isinstance(s, Group)]
    uses = {}
    if free:
        counted = set()
        for s in order:
            base = id(getattr(s, "_base", None) or s)
            if base in counted:
                continue
            counted.add(base)
            for i in s._inputs:
                uses[_key(i)] = uses.get(_key(i), 0) + 1
        for r in roots:
            uses[_key(r)] = uses.get(_key(r), 0) + 1
    for s in order:
        k = _key(s)
        if k in cache:
            continue
        if s.is_var:
            if s.name not in bindings:
                raise ValueError("unbound variable %r" % s.name)
            cache[k] = bindings[s.name]
            continue
        base_key = (k[0], None)
        if base_key not in cache:
            cache[base_key] = s._op(*[cache[_key(i)] for i in s._inputs],
                                    **s._kwargs)
            if free:
                for i in s._inputs:
                    ik = _key(i)
                    uses[ik] -= 1
                    if not uses[ik]:
                        cache.pop(ik, None)
        if s._output_index is not None:
            cache[k] = cache[base_key][s._output_index]
    return [cache[_key(r)] for r in roots]


_NAME_COUNT = {}


def _auto_name(hint):
    c = _NAME_COUNT.get(hint, 0)
    _NAME_COUNT[hint] = c + 1
    return "%s%d" % (hint, c)


_SCALAR_FNS = {}


def _scalar_binop_fn(fn):
    """The scalar form of a binary op, driven by its kwargs: one function
    per op, so that load_json resolves '<name>_scalar' nodes."""
    if fn not in _SCALAR_FNS:
        def op(a, scalar=0.0, reverse=False, _fn=fn):
            return _fn(scalar, a) if reverse else _fn(a, scalar)
        _SCALAR_FNS[fn] = op
    return _SCALAR_FNS[fn]


def var(name, shape=None, dtype=None, lr_mult=None, wd_mult=None, init=None,
        **kwargs):
    """A free variable; lr_mult/wd_mult/init and other keywords become
    ``__lr_mult__``/``__wd_mult__``/... attributes (``attr_dict``)."""
    s = Symbol(name=name)
    s._shape = shape
    s._dtype = dtype
    if lr_mult is not None:
        kwargs["__lr_mult__"] = lr_mult
    if wd_mult is not None:
        kwargs["__wd_mult__"] = wd_mult
    if init is not None:
        kwargs["__init__"] = init
    if kwargs:
        s._set_attr(**kwargs)
    return s


Variable = var


def zeros(shape, dtype="float32", **kw):
    return Symbol(op=lambda: nd.zeros(shape, dtype=dtype), op_name="zeros",
                  inputs=[])


def ones(shape, dtype="float32", **kw):
    return Symbol(op=lambda: nd.ones(shape, dtype=dtype), op_name="ones",
                  inputs=[])


def load(fname):
    with open(fname) as f:
        return load_json(f.read())


def load_json(json_str):
    """Rebuild a Symbol DAG from graph JSON (ops resolved from ``nd``)."""
    from . import _op_lookup, _deferred_rules

    graph = json.loads(json_str)
    nodes = graph["nodes"]
    built = []
    for node in nodes:
        if node["op"] == "null":
            built.append(var(node["name"]))
        else:
            fn = _op_lookup(node["op"])
            inputs = [built[i[0]] for i in node["inputs"]]
            kwargs = {k: _parse_attr(v) for k, v in node.get("attrs", {}).items()}
            if "__arg_spec__" in kwargs:
                # an op over lists of arrays: the flat → nested adapter
                from . import _flat_adapter
                fn = _flat_adapter(fn, tuple(kwargs["__arg_spec__"]))
            # the shape rules of the parameter variables layer ops made
            rules = _deferred_rules(node["op"], kwargs)
            for idx, shape_fn in (rules or {}).items():
                if idx < len(inputs) and inputs[idx].is_var:
                    v = inputs[idx]
                    if not hasattr(v, "_deferred_shape_fn"):
                        v._deferred_shape_fn = shape_fn
                        v._is_param = True
                        if node["op"] == "BatchNorm" and idx >= 3:
                            v._is_aux = True
            if node["op"] in _LOSS_OPS and len(inputs) > 1 and \
                    inputs[1].is_var:
                inputs[1]._is_label = True
            s = Symbol(op=fn, op_name=node["op"],
                       inputs=inputs, kwargs=kwargs, name=node["name"])
            built.append(s)
    return built[graph["heads"][0][0]]


_LOSS_OPS = ("SoftmaxOutput", "LinearRegressionOutput",
             "LogisticRegressionOutput", "MAERegressionOutput")


def _parse_attr(v):
    import ast
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _is_label(v):
    return bool(getattr(v, "_is_label", False)) or v.name.endswith("_label")


class _Unknown(Exception):
    pass


def _infer(symbol, shapes, dtypes=None, label_default=False, device=_META):
    """Run ``symbol``'s DAG on zero tensors of ``device`` (meta: nothing is
    allocated) with the variables of ``shapes``; a parameter variable of a
    layer op not in ``shapes`` takes its rule's shape from the op's data,
    and with ``label_default`` a label variable not in it takes (batch,),
    the inference bind's zeros. Returns ({variable: shape}, [outputs]) or
    None when a variable stays unknown. An op that cannot run on meta
    tensors sends the whole run to zeros on the CPU."""
    shapes = dict(shapes)
    dtypes = dtypes or {}
    roots = symbol._symbols if isinstance(symbol, Group) else [symbol]
    cache = {}

    def leaf(name):
        return NDArray(torch.zeros(shapes[name], device=device,
                                   dtype=dtypes.get(name, torch.float32)))

    def value(s, cache):
        """The output of operator node ``s`` on the values in ``cache``;
        a parameter variable not there takes its shape from the data (the
        first input known). A subgraph node (``subgraph.partition``) runs
        member by member, so each parameter meets its own operator's
        data."""
        args = [cache.get(_key(i)) for i in s._inputs]
        inner = getattr(s, "_subgraph", None)
        if inner is not None:
            ext, members = inner
            vals = {_key(e): a for e, a in zip(ext, args) if a is not None}
            for m in members:
                vals[(id(m), None)] = value(m, vals)
            return vals[(id(members[-1]), None)]
        data = next((a for a in args if a is not None), None)
        for j, i in enumerate(s._inputs):
            if args[j] is None:
                if data is None or not getattr(i, "_deferred_shape_fn",
                                               None):
                    raise _Unknown(i.name)
                shapes[i.name] = tuple(
                    int(d) for d in i._deferred_shape_fn(data.shape))
                args[j] = cache[_key(i)] = leaf(i.name)
        return s._op(*args, **s._kwargs)

    def run():
        for s in _postorder(roots):
            if isinstance(s, Group):
                continue
            k = _key(s)
            if k in cache:
                continue
            if s.is_var:
                if s.name in shapes:
                    cache[k] = leaf(s.name)
                elif getattr(s, "_deferred_shape_fn", None):
                    continue        # made from its consumer's data
                elif label_default and _is_label(s) and shapes:
                    shapes[s.name] = (next(iter(shapes.values()))[0],)
                    cache[k] = leaf(s.name)
                else:
                    raise _Unknown(s.name)
                continue
            base_key = (k[0], None)
            if base_key not in cache:
                cache[base_key] = value(s, cache)
            if s._output_index is not None:
                cache[k] = cache[base_key][s._output_index]
        outs = []
        for r in roots:
            o = cache[_key(r)]
            outs.extend(o if isinstance(o, (list, tuple)) else [o])
        return outs

    try:
        # creation ops (no inputs) make host arrays; beside meta tensors
        # they send the run to the CPU
        with autograd.pause(train_mode=False), cpu():
            outs = run()
    except _Unknown:
        return None
    except (NotImplementedError, RuntimeError):
        if device != _META:
            raise
        return _infer(symbol, shapes, dtypes, label_default,
                      torch.device("cpu"))
    return shapes, outs
