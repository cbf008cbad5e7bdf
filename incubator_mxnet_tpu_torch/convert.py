"""Carry weights between the JAX package and the port.

``arrays`` is a dict of structural name → numpy array, as the JAX package
gives it::

    {k: p.data().asnumpy()
     for k, p in jax_net._collect_params_with_prefix().items()}

The port's blocks use the same structural names, and Dense weights are
(units, in_units) in both packages, so the copy needs no renaming and no
transpose. ``to_numpy_params`` gives the port's parameters back in the
same form.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["from_jax_params", "to_numpy_params"]


def from_jax_params(net, arrays, strict=True):
    """Copy ``arrays`` into ``net``'s initialized parameters, each in the
    parameter's dtype and on its device. With ``strict`` the two key sets
    must be equal; every shared key's shape must match. A net whose keys
    all share one first component (a wrapper such as ``FeaturesView``,
    whose child is ``model``) also takes the arrays of the block it wraps,
    keyed without that prefix. Returns ``net``."""
    params = dict(net.collect_params().items())
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
        p, a = params[name], onp.asarray(arrays[name])
        if a.dtype.name == "bfloat16":     # ml_dtypes; torch cannot read it
            a = a.astype(onp.float32)
        if tuple(p.shape) != a.shape:
            raise ValueError("shape of %s: port %s, arrays %s"
                             % (name, tuple(p.shape), a.shape))
        p.set_data(a)
    return net


def to_numpy_params(net):
    """Structural name → the parameter's value as a float32 numpy array."""
    return {name: p.data().detach().float().cpu().numpy()
            for name, p in net.collect_params().items()}
