"""Tensor parallelism (counterpart of
``incubator_mxnet_tpu/parallel/tensor_parallel.py``).

Megatron-style column and row parallel linear layers. As in the JAX
package, a layer is a ``Dense`` whose weight carries a partition spec over
the ``tp`` mesh axis (``Parameter.sharding``); GSPMD partitions the matmul
there, and here ``Dense.forward`` hands a layer whose spec names an axis of
the current mesh (``mesh.current_mesh()``, size > 1) to ``dense_forward``,
which runs the matmul per shard through ``shard_map``:

- column parallel (weight ``P(tp, None)``, bias ``P(tp)``): each position
  computes its slice of the output features, and the slices are gathered;
- row parallel (weight ``P(None, tp)``): each position multiplies its slice
  of the input features by its slice of the weight, the partial products
  are summed in fp32 (``psum``) and cast back, then the replicated bias is
  added.

Each position reads its slice of the weight as a view of the parameter
(on its own device, a copy of the slice): the parameter itself stays one
global tensor, so ``data()``, saving, loading and eager use see the global
value. Outputs are gathered at each layer's boundary, so a model's
global-view code runs unchanged; keeping activations split between a
column layer and its row layer (the Megatron pattern) is a follow-up.
"""
from __future__ import annotations

import re

import torch

from ..gluon import nn
from .compat import _axes, psum, shard_map
from .mesh import P, current_mesh

__all__ = ["ColParallelDense", "RowParallelDense", "shard_params",
           "dense_forward"]


class ColParallelDense(nn.Dense):
    """Dense with output features split over ``tp`` (weight rows split):
    ``y = x Wᵀ`` with W (units, in) split on dim 0. Follow with
    ``RowParallelDense`` to contract back (the Megatron MLP pattern)."""

    def __init__(self, units, tp_axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self.weight.sharding = P(tp_axis, None)
        if self.bias is not None:
            self.bias.sharding = P(tp_axis)


class RowParallelDense(nn.Dense):
    """Dense with input features split over ``tp`` (weight columns split):
    the partial products are summed over ``tp``."""

    def __init__(self, units, tp_axis="tp", **kwargs):
        super().__init__(units, **kwargs)
        self.weight.sharding = P(None, tp_axis)
        # bias replicated


def shard_params(block, rules, mesh=None):
    """Annotate parameters by name pattern → partition spec. ``rules``: a
    list of (regex, spec); the first match wins."""
    compiled = [(re.compile(pat), spec) for pat, spec in rules]
    for name, p in block.collect_params().items():
        for pat, spec in compiled:
            if pat.search(name):
                p.sharding = spec
                break
    return block


def _split_axis(spec, mesh):
    """(dimension, axis name) of the one mesh axis a weight spec splits
    over, when the mesh has it with more than one position; else None."""
    if mesh is None:
        return None
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes(entry)
        if len(axes) != 1:
            raise ValueError("a Dense weight splits over one mesh axis; got "
                             "%s" % (tuple(spec),))
        a = axes[0]
        if mesh.shape.get(a, 1) > 1:
            return d, a
        return None
    return None


def dense_forward(layer, x):
    """``layer``'s fully-connected output computed per shard when its
    weight's spec splits over an axis of the current mesh; None otherwise
    (the caller runs the plain forward)."""
    found = _split_axis(layer.weight.sharding, current_mesh())
    if found is None:
        return None
    dim, axis = found
    mesh = current_mesh()
    w = layer.weight._tensor()
    b = layer.bias._tensor() if layer.bias is not None else None
    if layer._flatten:
        x = x.reshape(x.shape[0], -1)
    lead = (None,) * (x.dim() - 1)
    if dim == 0:
        # the bias splits with the output features when its spec says so
        # (one fused product a shard); a replicated one is added after
        split_bias = b is not None and \
            tuple(layer.bias.sharding or ()) == (axis,)
        out = shard_map(torch.nn.functional.linear, mesh,
                        in_specs=(P(), P(axis, None), P(axis)),
                        out_specs=P(*lead, axis), axes=(axis,))(
            x, w, b if split_bias else None)
        return out if b is None or split_bias else out + b

    def row(xs, ws):
        part = torch.nn.functional.linear(xs, ws)
        return psum(part.float(), axis)
    out = shard_map(row, mesh, in_specs=(P(*lead, axis), P(None, axis)),
                    out_specs=P(), axes=(axis,))(x, w)
    out = out.to(x.dtype)
    return out if b is None else out + b
