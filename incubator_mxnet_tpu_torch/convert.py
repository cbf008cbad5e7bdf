"""Carry weights between the JAX package and the port.

``arrays`` is a dict of structural name → numpy array or NDArray (of
either package: anything with ``asnumpy()``), as the JAX package gives
it::

    {k: p.data()
     for k, p in jax_net._collect_params_with_prefix().items()}

The port's blocks use the same structural names, and Dense weights are
(units, in_units) in both packages, so the copy needs no renaming and no
transpose. The one exception is the fused RNN layers: the JAX package
keeps their parameters in lists (``_i2h``, ``_h2h``, ``_i2hb``,
``_h2hb``, one entry per layer and direction), out of its structural
names, where the port registers them as MXNet does
(``lstm.l0_i2h_weight`` …). Given the JAX net itself,
``from_jax_params`` takes them from those lists under the port's names
(``jax_arrays``). ``to_numpy_params`` gives the port's parameters back in
the same form. A ``.params`` file is the other route: ``save_parameters``
in one package and ``load_parameters`` in the other carry the same names,
bfloat16 bit for bit (but for the fused RNN layers' weights, which the
JAX package's file leaves out).

``tinylm_from_jax`` builds the port's generative ``TinyLM`` from the JAX
package's (whose weights are plain arrays, not Gluon parameters), so both
compute the same thing.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["from_jax_params", "jax_arrays", "to_numpy_params",
           "tinylm_from_jax"]


def jax_arrays(jax_net):
    """Structural name → array of every parameter of a JAX package block:
    its ``_collect_params_with_prefix()`` and, for each fused RNN layer in
    it, the entries of its parameter lists under MXNet's names (index
    ``layer · directions + direction`` is ``{l,r}{layer}_…``)."""
    out = {k: p.data() for k, p in
           jax_net._collect_params_with_prefix().items()}

    def walk(block, prefix):
        if hasattr(block, "_i2h"):
            for kind, params in (("i2h_weight", block._i2h),
                                 ("h2h_weight", block._h2h),
                                 ("i2h_bias", block._i2hb),
                                 ("h2h_bias", block._h2hb)):
                for idx, p in enumerate(params):
                    layer, d = divmod(idx, block._dir)
                    out["%s%s%d_%s" % (prefix, "lr"[d], layer, kind)] = \
                        p.data()
        for name, child in block._children.items():
            walk(child, prefix + name + ".")
    walk(jax_net, "")
    return out


def from_jax_params(net, arrays, strict=True):
    """Copy ``arrays`` (or the parameters of a JAX package block, through
    ``jax_arrays``) into ``net``'s initialized parameters, each in the
    parameter's dtype and on its device. With ``strict`` the two key sets
    must be equal; every shared key's shape must match. A net whose keys
    all share one first component (a wrapper such as ``FeaturesView``,
    whose child is ``model``) also takes the arrays of the block it wraps,
    keyed without that prefix. Returns ``net``."""
    if hasattr(arrays, "_collect_params_with_prefix"):
        arrays = jax_arrays(arrays)
    params = net._collect_params_with_prefix()
    heads = {k.split(".", 1)[0] + "." for k in params}
    if set(params) != set(arrays) and len(heads) == 1:
        head = heads.pop()
        inner = {k[len(head):]: p for k, p in params.items()}
        if set(inner) == set(arrays):
            params = inner
    mine, theirs = set(params.keys()), set(arrays)
    if strict and mine != theirs:
        raise KeyError("parameter names differ: missing in arrays %s, extra "
                       "in arrays %s" % (sorted(mine - theirs),
                                         sorted(theirs - mine)))
    for name in sorted(mine & theirs):
        a = arrays[name]
        p, a = params[name], onp.asarray(
            a.asnumpy() if hasattr(a, "asnumpy") else a)
        if a.dtype.name == "bfloat16":     # ml_dtypes; torch cannot read it
            a = a.astype(onp.float32)
        if tuple(p.shape) != a.shape:
            raise ValueError("shape of %s: port %s, arrays %s"
                             % (name, tuple(p.shape), a.shape))
        p.set_data(a)
    return net


def to_numpy_params(net):
    """Structural name → a float32 numpy copy of the parameter's value (a
    snapshot: later updates of the parameter do not change it)."""
    return {name: p._tensor().detach().float().cpu().numpy().copy()
            for name, p in net.collect_params().items()}


def tinylm_from_jax(jax_tinylm, ctx=None):
    """The port's ``serving.generate.TinyLM`` with the weights of the JAX
    package's ``TinyLM`` (its ``emb`` and per-layer ``wq``, ``wk``, ``wv``,
    ``wo``, ``w1``, ``w2``, carried as numpy arrays) and its seed, on
    ``ctx`` (default: the current context)."""
    from .serving.generate import TinyLM
    weights = {"emb": onp.asarray(jax_tinylm.emb),
               "layers": [{k: onp.asarray(v) for k, v in layer.items()}
                          for layer in jax_tinylm.layers]}
    return TinyLM(jax_tinylm.seed, ctx=ctx, weights=weights)
