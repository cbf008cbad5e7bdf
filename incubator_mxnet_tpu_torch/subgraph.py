"""Subgraph partitioning, the custom-backend hook (counterpart of
``incubator_mxnet_tpu/subgraph.py``; ref
src/operator/subgraph/subgraph_property.h:252 SubgraphProperty and
python/mxnet symbol.optimize_for).

A backend (``SubgraphProperty``) claims operators (``match``); connected
claimed operators are grouped into one subgraph node of the ``Symbol``,
whose function the backend may wrap (``create_subgraph_op``: quantize,
compile, hand to a vendor library). A partitioned Symbol stays a Symbol:
a subgraph node runs its members through the same ``nd`` operators in
their order, so ``bind``/``simple_bind``, ``Module``, forward and
gradients work on it as on the graph it came from. The layer ops'
parameter variables keep their shape rules: shape inference
(``symbol._infer``) runs a subgraph node member by member, so a
parameter takes its shape from its own operator's data.

Usage::

    class MyBackend(SubgraphProperty):
        def match(self, node):              # an op whitelist
            return node._op_name in ("Convolution", "BatchNorm")
    register_backend("my_backend", MyBackend)
    part = sym.optimize_for("my_backend")   # or subgraph.partition(sym, ...)
"""
from __future__ import annotations

__all__ = ["SubgraphProperty", "register_backend", "get_backend", "partition"]

_BACKENDS = {}


class SubgraphProperty:
    """Backend description: which nodes it claims, and how to wrap them
    (ref subgraph_property.h SubgraphProperty / SubgraphSelector)."""

    name = "base"

    def match(self, node):
        """Whether this backend claims ``node`` (a non-variable Symbol)."""
        raise NotImplementedError

    def pre_partition(self, sym):
        return sym

    def post_partition(self, sym):
        return sym

    def create_subgraph_op(self, fn, nodes):
        """Hook: wrap the fused callable (e.g. quantize/compile it)."""
        return fn


def register_backend(name, prop_cls):
    """ref MXNET_REGISTER_SUBGRAPH_BACKEND / subgraph_property.h:429."""
    _BACKENDS[name] = prop_cls
    return prop_cls


def get_backend(name):
    if name not in _BACKENDS:
        raise ValueError("subgraph backend %r not registered (have: %s)"
                         % (name, sorted(_BACKENDS)))
    return _BACKENDS[name]()


def _base(s):
    return getattr(s, "_base", None) or s


def _components(nodes, prop):
    """{id(root): members in graph order} of the claimed components with
    one value used outside them (the root, their last member)."""
    from .symbol.symbol import Group
    matched = {id(n) for n in nodes
               if not n.is_var and not isinstance(n, Group)
               and n._num_outputs == 1 and prop.match(n)}
    consumers = {}
    for n in nodes:
        for i in n._inputs:
            consumers.setdefault(id(_base(i)), []).append(n)
    parent = {i: i for i in matched}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for n in nodes:
        if id(n) in matched:
            for i in n._inputs:
                if id(_base(i)) in matched:
                    parent[find(id(n))] = find(id(_base(i)))
    groups = {}
    for n in nodes:
        if id(n) in matched:
            groups.setdefault(find(id(n)), []).append(n)
    fuse = {}
    for comp in groups.values():
        if len(comp) < 2:
            continue
        ids = {id(n) for n in comp}
        outward = [n for n in comp
                   if not consumers.get(id(n))
                   or any(id(c) not in ids for c in consumers[id(n)])]
        if len(outward) == 1:
            fuse[id(outward[0])] = comp
    return fuse


def _fused_fn(ext, members):
    """The subgraph node's function: the members' operators in order on
    the values of its external inputs."""
    from .symbol.symbol import _key

    def fused(*ext_vals):
        vals = {_key(e): v for e, v in zip(ext, ext_vals)}
        for m in members:
            vals[(id(m), None)] = m._op(*[vals[_key(i)] for i in m._inputs],
                                        **m._kwargs)
        return vals[(id(members[-1]), None)]
    return fused


def partition(sym, backend):
    """Group claimed, connected operators into subgraph nodes.

    The contract of the JAX package (conservative, like the reference's
    default selector): only single-output operators are claimed, and a
    component is fused only when one of its values is used outside it (a
    component whose intermediate values are consumed outside stays
    unfused). Multi-output heads are left to a backend's own selector."""
    from .symbol.symbol import Group, Symbol, _key, _postorder

    prop = backend if isinstance(backend, SubgraphProperty) else \
        get_backend(backend)
    sym = prop.pre_partition(sym)
    roots = sym._symbols if isinstance(sym, Group) else [sym]
    nodes, seen = [], set()     # producing nodes, inputs first
    for n in _postorder(roots):
        if id(_base(n)) not in seen:
            seen.add(id(_base(n)))
            nodes.append(_base(n))
    fuse = _components(nodes, prop)
    if not fuse:
        return prop.post_partition(sym)

    inner = {id(m) for comp in fuse.values() for m in comp[:-1]}
    rebuilt = {}

    def ref(s):
        new = rebuilt[id(_base(s))]
        return new if s._output_index is None else new[s._output_index]

    for n in nodes:                  # inputs first: one pass rebuilds
        if n.is_var:
            rebuilt[id(n)] = n
        elif id(n) in inner:
            continue                 # runs inside its subgraph node
        elif id(n) in fuse:
            members = fuse[id(n)]
            ids = {id(m) for m in members}
            # external inputs in first-use order, one per (node, output):
            # two outputs of one node stay distinct
            ext, seen = [], set()
            for m in members:
                for i in m._inputs:
                    if id(_base(i)) not in ids and _key(i) not in seen:
                        seen.add(_key(i))
                        ext.append(i)
            fn = prop.create_subgraph_op(_fused_fn(ext, members), members)
            new = Symbol(op=fn, op_name="_subgraph_%s" % prop.name,
                         inputs=[ref(e) for e in ext],
                         name="%s_subgraph%d" % (prop.name, len(rebuilt)))
            new._subgraph = (tuple(ext), tuple(members))
            rebuilt[id(n)] = new
        elif isinstance(n, Group):
            rebuilt[id(n)] = Group([ref(i) for i in n._symbols])
        else:
            new = Symbol(op=n._op, op_name=n._op_name,
                         inputs=[ref(i) for i in n._inputs],
                         kwargs=n._kwargs, name=n.name,
                         num_outputs=n._num_outputs)
            new._attr = dict(n._attr)
            rebuilt[id(n)] = new
    out = Group([ref(s) for s in roots]) if isinstance(sym, Group) \
        else ref(sym)
    return prop.post_partition(out)
