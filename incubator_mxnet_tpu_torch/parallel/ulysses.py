"""Ulysses-style sequence parallelism: all-to-all head scatter (counterpart
of ``incubator_mxnet_tpu/parallel/ulysses.py``).

Tokens arrive split on the sequence axis; an all-to-all makes them split on
heads instead (each position holds every token of H/n heads), attention
runs locally over the full sequence — ``flash_attention``, so one K1 per
position per call on a legal shape, and K2+K3 in its backward — and a second
all-to-all restores the sequence split. Requires num_heads % axis size ==
0 and S % axis size == 0.
"""
from __future__ import annotations

import functools

from .compat import all_to_all, axis_size, shard_map  # noqa: F401
from .mesh import P
from .ring_attention import local_attention

__all__ = ["ulysses_attention"]


def _ulysses_sharded(q, k, v, axis_name, causal, scale):
    """Inside shard_map: q/k/v local shapes (B, H, S/n, D)."""

    def seq_to_heads(x):
        # (B, H, s, D) -> (B, H/n, S, D): split heads, gather the sequence
        return all_to_all(x, axis_name, split_axis=1, concat_axis=2,
                          tiled=True)

    def heads_to_seq(x):
        return all_to_all(x, axis_name, split_axis=2, concat_axis=1,
                          tiled=True)

    qh, kh, vh = (seq_to_heads(t).contiguous() for t in (q, k, v))
    from ..ops.attention import flash_attention, flash_attention_supported
    if flash_attention_supported(qh.shape, kh.shape, vh.shape):
        out = flash_attention(qh, kh, vh, causal, scale)
    else:
        o, m, l = local_attention(qh, kh, vh, scale=scale, causal=causal)
        out = (o / l.clamp_min(1e-37)).to(q.dtype)
    return heads_to_seq(out)


def ulysses_attention(q, k, v, mesh=None, axis="sp", causal=False,
                      scale=None):
    """Sequence-parallel attention through head-scatter all-to-all: q/k/v
    (B, H, S, D) global, split on the sequence over mesh axis ``axis``;
    returns the same layout. H and S must divide the axis size."""
    from .mesh import current_mesh
    mesh = mesh or current_mesh()
    n = mesh.shape[axis]
    if q.shape[1] % n:
        raise ValueError("num_heads %d not divisible by %s=%d"
                         % (q.shape[1], axis, n))
    fn = functools.partial(_ulysses_sharded, axis_name=axis, causal=causal,
                           scale=scale)
    spec = P(None, None, axis, None)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False, axes=(axis,))(q, k, v)
