"""Carry weights from the JAX package into the port.

``arrays`` is a dict of structural name → numpy array, as the JAX package
gives it::

    {k: p.data().asnumpy()
     for k, p in jax_net._collect_params_with_prefix().items()}

The port's blocks use the same structural names, and Dense weights are
(units, in_units) in both packages, so the copy needs no renaming and no
transpose.
"""
from __future__ import annotations

import numpy as onp

__all__ = ["from_jax_params"]


def from_jax_params(net, arrays, strict=True):
    """Copy ``arrays`` into ``net``'s initialized parameters, each in the
    parameter's dtype and on its device. With ``strict`` the two key sets
    must be equal; every shared key's shape must match. Returns ``net``."""
    params = net.collect_params()
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
