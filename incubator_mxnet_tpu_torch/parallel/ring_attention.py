"""Ring attention: sequence parallelism over a mesh axis (counterpart of
``incubator_mxnet_tpu/parallel/ring_attention.py``).

The sequence axis of q, k and v is split over the ``sp`` mesh axis; each
position holds a Q block and streams the K/V blocks around the ring with
``ppermute``, keeping an online-softmax partial (o, m, l) in fp32. The local
step is ``ops.attention.attention_with_lse``: on CUDA tensors of a legal
shape that is K1 forward (``flash_attention_lse``, whose LSE output is
differentiable), and K2+K3 in the backward with the LSE cotangent folded
into delta; other shapes take the dense composite, as in the JAX package.

The causal decomposition is static per position (``axis_index`` is a
Python int): the position's own block runs the causal kernel, blocks from
earlier positions (src < idx) run the full one, and blocks from later
positions contribute the empty partial ``(0, -inf, 0)`` and launch nothing.
So a causal ring over n positions launches K1 n + n(n-1)/2 times per
attention, a full ring n² times, and K2 and K3 as often in the backward.
"""
from __future__ import annotations

import functools
import math

import torch

from .compat import axis_index, axis_size, ppermute, shard_map
from .mesh import P

__all__ = ["ring_attention", "local_attention"]


def local_attention(q, k, v, scale=None, causal=False, q_offset=0,
                    kv_offset=0):
    """Plain blockwise attention on local shards (fp32 softmax
    accumulators). q: (B, H, Sq, D), k/v: (B, H, Sk, D). Returns (out,
    row_max, row_sumexp) for online-softmax combination."""
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        qi = torch.arange(q.shape[2], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[2], device=q.device)[None, :] + kv_offset
        s = torch.where(qi >= ki, s, torch.full_like(s, -math.inf))
    m = s.amax(dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe)
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o, m, l


def _safe_exp_diff(mi, m):
    """``exp(mi - m)``, 0 where ``mi`` is -inf, with no NaN in the value or
    its gradient (the difference is taken only where it is finite)."""
    finite = torch.isfinite(mi)
    diff = torch.where(finite, mi - torch.where(finite, m,
                                                torch.zeros_like(m)),
                       torch.zeros_like(mi))
    return torch.where(finite, torch.exp(diff), torch.zeros_like(mi))


def _combine(o1, m1, l1, o2, m2, l2):
    """Merge two online-softmax partials."""
    m = torch.maximum(m1, m2)
    a1 = _safe_exp_diff(m1, m)
    a2 = _safe_exp_diff(m2, m)
    o = o1 * a1 + o2 * a2
    l = l1 * a1 + l2 * a2
    return o, m, l


def _local_partials(q, k, v, scale, causal):
    """One local step as an online-softmax partial (o, m, l): through the
    kernels for a legal shape — (out, lse) is the partial (out, lse, 1) —
    else the dense composite."""
    from ..ops.attention import attention_with_lse, flash_attention_supported
    if flash_attention_supported(q.shape, k.shape, v.shape):
        out, lse = attention_with_lse(q, k, v, causal=causal, scale=scale)
        return (out.float(), lse[..., None],
                torch.ones(lse.shape + (1,), dtype=torch.float32,
                           device=lse.device))
    return local_attention(q, k, v, scale=scale, causal=causal)


def _ring_attention_sharded(q, k, v, axis_name, causal, scale):
    """Inside shard_map: the local block, then n-1 ring exchanges of K/V."""
    n = axis_size(axis_name)
    idx = axis_index(axis_name)
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    # a shard of the sequence dim is a strided view: the kernels read
    # dense (B, H, S, D) rows, and the ring passes the dense copies on
    q, k, v = (t.contiguous() for t in (q, k, v))
    o, m, l = _local_partials(q, k, v, scale, causal)
    kk, vv = k, v
    perm = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n - 1):
        # pass K/V to the next position on the ring
        kk = ppermute(kk, axis_name, perm)
        vv = ppermute(vv, axis_name, perm)
        src = (idx - i - 1) % n           # whose block this position holds
        if causal and src > idx:
            continue                      # (0, -inf, 0): merges to a no-op
        oi, mi, li = _local_partials(q, kk, vv, scale, False)
        o, m, l = _combine(o, m, l, oi, mi, li)
    return (o / l.clamp_min(1e-37)).to(q.dtype)


def ring_attention(q, k, v, mesh=None, axis="sp", causal=False, scale=None):
    """Sequence-parallel attention: q/k/v (B, H, S, D) global, split on the
    sequence dim (2) over mesh axis ``axis``; returns the same layout,
    joined on the device of the mesh's first position."""
    from .mesh import current_mesh
    mesh = mesh or current_mesh()
    fn = functools.partial(_ring_attention_sharded, axis_name=axis,
                           causal=causal, scale=scale)
    spec = P(None, None, axis, None)
    return shard_map(fn, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec, check_vma=False, axes=(axis,))(q, k, v)
