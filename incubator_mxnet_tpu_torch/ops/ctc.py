"""Connectionist temporal classification loss (counterpart of
``incubator_mxnet_tpu/ops/ctc.py``; MXNet's ``nn/ctc_loss.cc``, warp-ctc's
semantics).

The reference's log-space alpha recursion, as a loop over time in torch
ops: the extended label sequence (blank, l1, blank, l2, ..., blank) padded
to S = 2L + 1, one step per frame over an (N, S) lattice, and the gradient
from autograd through the loop, as the JAX package takes it through its
``lax.scan``. The emission of every frame and extended symbol comes from
one gather before the loop (whose backward sums in a fixed order, so that
a step repeats bit for bit on the card), unbound into frames once (so the
backward stacks their gradients once). Each step then costs a few
elementwise kernels, ~10 launches a frame forward and more backward:
inside a captured training step the CUDA graph replays them without the
host.

The contract, the reference's:

- ``x`` (T, N, C): unnormalised activations; the log-softmax is taken
  here, in fp32.
- ``labels`` (N, L): entries < 0 are padding when no label lengths are
  given; ids are clamped into [0, C) before the gather, as ``jnp``
  indexing clamps them, so an id ≥ C reads class C - 1 (never a
  device-side assert).
- blank is class 0 (``"first"``) or C - 1 (``"last"``).
- ``data_lengths``: past its length a sample's lattice freezes.
- an impossible alignment gives a loss near 1e30, not inf: -1e30 stands
  for log 0 and the sum inside each log-sum-exp is clamped at 1e-37.
- returns the negative log-likelihood of each sample, (N,) fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["ctc_loss"]

_NEG = -1e30


def _lse(*xs):
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    s = sum(torch.exp(x - m) for x in xs)
    return m + torch.log(torch.clamp_min(s, 1e-37))


class _Emit(torch.autograd.Function):
    """``logp`` (T, N, C) gathered at the extended symbols ``ext`` (N, S):
    (T, N, S). Its backward adds each symbol's gradient into its class
    through a one-hot sum over S, in a fixed order: a gather's own
    backward scatters with atomics on the card, whose order, and so the
    rounding, changes from run to run (the blank recurs at every even
    position)."""

    @staticmethod
    def forward(ctx, logp, ext):
        ctx.save_for_backward(ext)
        ctx.n_class = logp.shape[-1]
        return torch.gather(logp, 2, ext[None].expand(logp.shape[0], -1, -1))

    @staticmethod
    def backward(ctx, g):
        ext, = ctx.saved_tensors
        hot = (ext[..., None] == torch.arange(ctx.n_class, device=g.device)
               ).to(g.dtype)                                   # (N, S, C)
        return (g[..., None] * hot).sum(2), None


def ctc_loss(x, labels, data_lengths=None, label_lengths=None,
             blank_label="first"):
    t_len, n, c = x.shape
    big_l = labels.shape[1]
    s_len = 2 * big_l + 1
    dev = x.device
    logp = torch.log_softmax(x.float(), dim=-1)                 # (T, N, C)
    labels = labels.to(device=dev).long()
    if label_lengths is None:
        ll = (labels >= 0).sum(1)
    else:
        ll = label_lengths.to(device=dev).long()
    if data_lengths is None:
        dl = torch.full((n,), t_len, dtype=torch.long, device=dev)
    else:
        dl = data_lengths.to(device=dev).long()
    blank = 0 if blank_label == "first" else c - 1
    safe = torch.where(labels >= 0, labels, torch.full_like(labels, blank))

    pos = torch.arange(s_len, device=dev)
    is_lab = pos % 2 == 1
    lab_idx = torch.clamp(pos // 2, max=big_l - 1)
    ext = torch.where(is_lab[None], safe[:, lab_idx],
                      torch.full((1, s_len), blank, device=dev))  # (N, S)
    ext = ext.clamp(0, c - 1)
    valid = pos[None] < (2 * ll + 1)[:, None]
    ext_m2 = F.pad(ext[:, :-2], (2, 0), value=-1)
    can_skip = is_lab[None] & (ext != ext_m2)

    emit = _Emit.apply(logp, ext).unbind(0)          # T frames of (N, S)
    live = torch.arange(t_len, device=dev)[:, None] < dl[None]  # (T, N)
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)

    alpha = torch.full((n, s_len), _NEG, dtype=torch.float32, device=dev)
    first = torch.stack([emit[0][:, 0],
                         torch.where(ll > 0, emit[0][:, 1], neg)], 1)
    alpha = torch.cat([first, alpha[:, 2:]], 1)
    for t in range(1, t_len):
        prev1 = F.pad(alpha[:, :-1], (1, 0), value=_NEG)
        prev2 = torch.where(can_skip, F.pad(alpha[:, :-2], (2, 0),
                                            value=_NEG), neg)
        a = torch.where(valid, _lse(alpha, prev1, prev2) + emit[t], neg)
        alpha = torch.where(live[t][:, None], a, alpha)

    end = 2 * ll
    a_end = alpha.gather(1, end.clamp(0, s_len - 1)[:, None])[:, 0]
    a_end1 = torch.where(
        ll > 0, alpha.gather(1, (end - 1).clamp(0, s_len - 1)[:, None])[:, 0],
        neg)
    return -_lse(a_end, a_end1)
