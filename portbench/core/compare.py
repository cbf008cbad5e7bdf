"""The numbers that decide ``correct``, each held against its limit from
``limits/<cell>.json``.

Training (the program's first checked steps against the reference's, from
the same weights and batches; each step's loss gap, |loss - reference| /
|reference|, is reported in the detail and not compared: the fp8 control
reads under three times the program on it, and no fault ten times,
PERF.md):

- ``grad_norm_gap``: over the leaves, the largest gap between the norm of
  step 1's gradient as the program's optimizer got it and the reference's
  norm of it, over the larger of the reference's norm of that leaf and of
  the median leaf;
- ``grad_error``: over the leaves, the largest norm of the difference
  between step 1's gradient as the program's optimizer got it and the
  reference's, over the same denominator: first order in the error, where
  a gap of norms is second order in random rounding (step 2's reads, on
  top, where the two sides' first Adam steps, ±lr by the sign of each
  entry's gradient, chose differently on entries near zero: PERF.md);
- ``update_norm_gap``: as ``grad_norm_gap``, for the norm of the change of
  the net's own weights (bf16) over the checked steps, leaving out leaves
  whose reference gradient is under a thousandth of the median leaf's
  (nought to rounding, as a key's bias under softmax, which Adam moves by
  round-off alone).

Serving: ``reply_gap``, over the sampled replies, the largest error of
one reply (all its start and end logits) in units of the hidden state
behind it. A reply is a linear read-out, ``h Wᵀ + b`` at each of its P
positions, of a last hidden state that LayerNorm leaves at unit scale; an
error of RMS ε in h gives the reply an error of norm ε·√P·‖W‖_F. So
``reply_gap`` = ‖reply − reference‖ / (√P·‖W‖_F) estimates ε. Dividing by
the reference reply's own norm instead made the number swing threefold
from seed to seed with how the seed's W lines up with h (PERF.md).
"""
from __future__ import annotations

import statistics

import torch

SMALL_GRAD = 1e-3      # of the median leaf's gradient norm
GRAD_STEPS = (1,)      # the steps whose whole gradients are compared


def _worst(prog, ref, keep, scale=None):
    """(largest relative gap, its leaf) over the names in ``keep``: |prog -
    ref| over max(the reference's norm ``scale``, default ``ref``, of the
    leaf and of the median leaf)."""
    scale = ref if scale is None else scale
    med = statistics.median(scale.values())
    worst, at = 0.0, None
    for k in keep:
        gap = abs(prog[k] - ref[k]) / max(scale[k], med, 1e-30)
        if at is None or gap > worst:
            worst, at = gap, k
    return worst, at


class GradientError:
    """The gradients of one side held on the host ({step: {leaf:
    tensor}}), held against the other side's as its steps come
    (``plain.train``'s ``on_grad``): for each step, each leaf's norm of the
    difference and the reference's norm of it."""

    def __init__(self, held, held_is_reference):
        self.held, self.held_is_reference = held, held_is_reference
        self.diff, self.ref = {}, {}

    def __call__(self, t, grads):
        held = self.held.pop(t, None)
        if held is None:
            return
        diff, ref = self.diff.setdefault(t, {}), self.ref.setdefault(t, {})
        for k, g in grads.items():
            h = held[k].to(g.device, torch.float32)
            diff[k] = float((h - g.float()).norm())
            ref[k] = float((h if self.held_is_reference else g).norm())

    def worst(self):
        """(largest relative error, (step, leaf)) over the steps held."""
        worst, at = 0.0, None
        for t in sorted(self.diff):
            zeros = dict.fromkeys(self.diff[t], 0.0)
            gap, leaf = _worst(self.diff[t], zeros, list(self.diff[t]),
                               self.ref[t])
            if at is None or gap > worst:
                worst, at = gap, (t, leaf)
        return worst, at


def keep_gradients(steps=GRAD_STEPS):
    """(``on_grad`` hook, store): the hook copies the gradients of
    ``steps`` to the host into the store ({step: {leaf: tensor}})."""
    store = {}

    def hook(t, grads):
        if t in steps:
            store[t] = {k: g.detach().to("cpu", torch.float32, copy=True)
                        for k, g in grads.items()}
    return hook, store


def training(prog, ref, error):
    """``prog``/``ref``: (losses, {leaf: step-1 gradient norm}, {leaf:
    change norm of the net's weights}); ``error``: a ``GradientError``
    that has seen both sides. Returns ({number: value}, {number:
    detail})."""
    (pl, pg, pc), (rl, rg, rc) = prog, ref
    gaps = [abs(a - b) / abs(b) for a, b in zip(pl, rl)]
    grad_gap, grad_at = _worst(pg, rg, list(rg))
    med = statistics.median(rg.values())
    keep = [k for k in rg if rg[k] >= SMALL_GRAD * med]
    upd_gap, upd_at = _worst(pc, rc, keep)
    if sorted(error.diff) != sorted(GRAD_STEPS):
        raise RuntimeError("gradients compared at steps %s, not %s"
                           % (sorted(error.diff), list(GRAD_STEPS)))
    err, err_at = error.worst()
    numbers = {"grad_norm_gap": grad_gap, "grad_error": err,
               "update_norm_gap": upd_gap}
    detail = {"losses": pl, "reference_losses": rl, "loss_gaps": gaps,
              "grad_norm_gap_leaf": grad_at, "grad_error_at": err_at,
              "update_norm_gap_leaf": upd_at,
              "left_out_of_update": sorted(set(rg) - set(keep))[:3],
              "n_left_out_of_update": len(rg) - len(keep)}
    return numbers, detail


def serving(replies, reference, readout):
    """``replies``, ``reference``: fp32 tensors of one shape, a reply a
    row; ``readout``: the (outputs, hidden) matrix W of the reply's
    read-out, as the reference was given it."""
    n = reference.shape[0]
    positions = reference[0].numel() // readout.shape[0]
    unit = positions ** 0.5 * float(readout.float().norm())
    gaps = (replies - reference).reshape(n, -1).norm(dim=1) / unit
    return {"reply_gap": float(gaps.max())}, {
        "reply_gap_median": float(gaps.median()),
        "reference_rms": float(reference.pow(2).mean().sqrt())}


def checks(numbers, limits):
    """{number: {"value", "limit"}} and whether every number is within its
    limit. A number without a limit is an error: a limit is set for each
    from readings (PERF.md)."""
    out, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]
        out[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return out, ok
