"""MultiBox SSD operators (counterpart of
``incubator_mxnet_tpu/ops/multibox.py``; MXNet's ``multibox_prior.cc``,
``multibox_target.cc`` and ``multibox_detection.cc``).

Every operator works on tensors of static shapes, batched over images
without a per-image Python loop, and reads nothing back to the host: so
``MultiBoxTarget`` can run inside a captured ``jit.TrainStep``. The JAX
package leaves all of it to XLA, and the port leaves it to plain PyTorch.

Two departures from the JAX package, both MXNet's behaviour:

- ``MultiBoxTarget``: a ground-truth box forces its best anchor positive
  when the box is valid. The JAX package writes ``valid`` at every row's
  best anchor with one scatter of duplicate indices, so a padding row
  (class -1, IoU -1 with every anchor, best anchor 0) and a real box whose
  best anchor is anchor 0 write the same place and XLA leaves undefined
  which wins; the port ORs the valid rows' writes, as
  ``multibox_target.cc`` skips padding rows.
- ``MultiBoxDetection`` honours ``nms_topk``, which the JAX package
  accepts and never reads: only the ``nms_topk`` highest-scoring
  candidates enter non-maximum suppression and the others come out with
  class id -1, as in ``multibox_detection.cc``. With ``nms_topk`` -1, or
  at least the anchor count, every row equals the JAX package's. The
  suppression is greedy, one step per candidate, each step vectorised over
  the batch; its IoU matrix is candidates² per image.
"""
from __future__ import annotations

import numpy as onp
import torch

from ..ndarray.ndarray import _apply

__all__ = ["MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "box_iou"]


def _f32(x):
    """A Python scalar rounded to float32 (what the JAX package's weakly
    typed float32 arithmetic gives)."""
    return float(onp.float32(x))


def MultiBoxPrior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                  steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes at every pixel of ``data`` (N, C, H, W): (1, H·W·k, 4)
    corners in [0, 1], k = len(sizes) + len(ratios) - 1, in MXNet's order
    ((s_i, r_0) for every size, then (s_0, r_j) for ratios[1:])."""
    h, w = data.shape[2], data.shape[3]
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    half = [(onp.float32(s) * onp.sqrt(onp.float32(r)) / onp.float32(2),
             onp.float32(s) / onp.sqrt(onp.float32(r)) / onp.float32(2))
            for s, r in [(s, ratios[0]) for s in sizes]
            + [(sizes[0], r) for r in ratios[1:]]]

    def fn(x):
        kw = dict(dtype=torch.float32, device=x.device)
        cy = (torch.arange(h, **kw) + _f32(offsets[0])) * _f32(step_y)
        cx = (torch.arange(w, **kw) + _f32(offsets[1])) * _f32(step_x)
        cy, cx = torch.meshgrid(cy, cx, indexing="ij")        # (H, W)
        out = torch.stack([torch.stack([cx - float(bw), cy - float(bh),
                                        cx + float(bw), cy + float(bh)], -1)
                           for bw, bh in half], 2).reshape(-1, 4)
        if clip:
            out = out.clamp(0.0, 1.0)
        return out[None]
    return _apply(fn, data)


def _iou(a, b):
    """IoU of corner boxes a (..., Na, 4) against b (..., Nb, 4): (..., Na,
    Nb), 0 where the union is empty."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]).clamp_min(0) * \
        (a[..., 3] - a[..., 1]).clamp_min(0)
    area_b = (b[..., 2] - b[..., 0]).clamp_min(0) * \
        (b[..., 3] - b[..., 1]).clamp_min(0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def box_iou(a, b):
    """IoU matrix between (Na, 4) and (Nb, 4) corner boxes."""
    return _apply(_iou, a, b)


def _centers(boxes):
    """(width, height, centre x, centre y) of corner boxes (..., 4)."""
    return (boxes[..., 2] - boxes[..., 0], boxes[..., 3] - boxes[..., 1],
            (boxes[..., 0] + boxes[..., 2]) / 2,
            (boxes[..., 1] + boxes[..., 3]) / 2)


def _targets(anc, lbl, cp, overlap_threshold, ignore_label,
             negative_mining_ratio, variances):
    n, a = lbl.shape[0], anc.shape[0]
    valid = lbl[..., 0] >= 0                                    # (N, M)
    gt = lbl[..., 1:5]
    iou = torch.where(valid[:, None, :], _iou(anc, gt),
                      torch.full((), -1.0, device=lbl.device))   # (N, A, M)
    best_iou, best_gt = iou.max(dim=2)
    # each valid box forces its best anchor positive (an OR over boxes)
    forced = torch.zeros(n, a, device=lbl.device).scatter_add_(
        1, iou.argmax(dim=1), valid.float()) > 0
    pos = (best_iou >= overlap_threshold) | forced
    matched = torch.gather(lbl, 1, best_gt[..., None].expand(n, a, 5))
    aw, ah, acx, acy = _centers(anc)
    aw, ah = aw.clamp_min(1e-8), ah.clamp_min(1e-8)
    gw = (matched[..., 3] - matched[..., 1]).clamp_min(1e-8)
    gh = (matched[..., 4] - matched[..., 2]).clamp_min(1e-8)
    gcx = (matched[..., 1] + matched[..., 3]) / 2
    gcy = (matched[..., 2] + matched[..., 4]) / 2
    v = [_f32(x) for x in variances]
    loc = torch.stack([(gcx - acx) / aw / v[0], (gcy - acy) / ah / v[1],
                       torch.log(gw / aw) / v[2],
                       torch.log(gh / ah) / v[3]], -1)
    zero = torch.zeros((), device=lbl.device)
    loc = torch.where(pos[..., None], loc, zero)
    mask = pos[..., None].float().expand(n, a, 4)
    cls_t = torch.where(pos, matched[..., 0] + 1.0, zero)     # 0: background
    if negative_mining_ratio > 0:
        # hard negatives: the lowest background probability first, ties in
        # anchor order (a stable sort, as jnp.argsort)
        bg = torch.softmax(cp.float(), dim=1)[:, 0]            # (N, A)
        score = torch.where(pos, torch.full((), float("inf"),
                                            device=lbl.device), bg)
        n_pos = pos.sum(1)
        n_neg = torch.minimum((negative_mining_ratio * n_pos).int(),
                              a - n_pos.int())
        order = torch.argsort(score, dim=1, stable=True)
        rank = torch.empty_like(order).scatter_(1, order, torch.arange(
            a, device=lbl.device).expand(n, a))
        cls_t = torch.where(pos, cls_t, torch.where(
            rank < n_neg[:, None], zero,
            torch.full((), float(ignore_label), device=lbl.device)))
    return loc.reshape(n, -1), mask.reshape(n, -1), cls_t


def MultiBoxTarget(anchor, label, cls_pred, overlap_threshold=0.5,
                   ignore_label=-1, negative_mining_ratio=-1,
                   negative_mining_thresh=0.5, minimum_negative_samples=0,
                   variances=(0.1, 0.1, 0.2, 0.2)):
    """Training targets of every anchor (MXNet's ``MultiBoxTarget``).

    anchor (1, A, 4); label (N, M, 5) rows [cls, xmin, ymin, xmax, ymax],
    cls -1 for padding; cls_pred (N, classes + 1, A), read only for hard
    negative mining (``negative_mining_ratio`` > 0). Returns [loc_target
    (N, A·4), loc_mask (N, A·4), cls_target (N, A)]: cls_target 0 for
    background, class + 1 for a positive and ``ignore_label`` for a
    negative left out by the mining. Nothing is differentiated through."""

    def fn(anc, lbl, cp):
        with torch.no_grad():
            return list(_targets(anc[0].float(), lbl.float(), cp,
                                 overlap_threshold, ignore_label,
                                 negative_mining_ratio, variances))
    return _apply(fn, anchor, label, cls_pred)


def _decode(loc, anc, variances, clip):
    """Corner boxes (N, A, 4) from the predicted offsets (N, A, 4)."""
    v = [_f32(x) for x in variances]
    aw, ah, acx, acy = _centers(anc)
    cx = loc[..., 0] * v[0] * aw + acx
    cy = loc[..., 1] * v[1] * ah + acy
    w = torch.exp(loc[..., 2] * v[2]) * aw / 2
    h = torch.exp(loc[..., 3] * v[3]) * ah / 2
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], -1)
    return boxes.clamp(0.0, 1.0) if clip else boxes


def _gather_rows(x, order):
    """``x`` (N, A, ...) reordered along A by ``order`` (N, A')."""
    idx = order.reshape(order.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(order.shape + x.shape[2:]))


def greedy_nms(iou, alive, nms_threshold, cls=None):
    """Greedy suppression over candidates sorted by score: candidate i,
    while alive, removes every later one whose IoU with it exceeds
    ``nms_threshold`` (of its class when ``cls`` is given). iou (N, K, K),
    alive (N, K) bool, cls (N, K); one step per candidate, vectorised over
    the batch. Returns the alive mask after suppression."""
    k = alive.shape[1]
    later = torch.arange(k, device=alive.device)
    over = iou > nms_threshold
    if cls is not None:
        over &= cls[:, :, None] == cls[:, None, :]
    for i in range(k):
        alive = alive & ~(over[:, i] & (later > i) & alive[:, i:i + 1])
    return alive


def MultiBoxDetection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                      background_id=0, nms_threshold=0.5,
                      force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                      nms_topk=-1):
    """Decode and suppress (MXNet's ``MultiBoxDetection``).

    cls_prob (N, classes + 1, A) with class 0 the background; loc_pred
    (N, A·4); anchor (1, A, 4). Returns (N, A, 6) rows [class id, score,
    xmin, ymin, xmax, ymax], sorted by score, class id -1 where the score
    is at or below ``threshold``, beyond the ``nms_topk`` best, or
    suppressed."""

    def fn(cp, lp, anc):
        n, a = cp.shape[0], anc.shape[1]
        score, cls_id = cp[:, 1:].max(dim=1)                   # (N, A)
        boxes = _decode(lp.reshape(n, a, 4), anc[0], variances, clip)
        keep = score > threshold
        ninf = torch.full((), float("-inf"), dtype=score.dtype,
                          device=score.device)
        order = torch.argsort(-torch.where(keep, score, ninf), dim=1,
                              stable=True)
        keep_o = torch.gather(keep, 1, order)
        boxes_o = _gather_rows(boxes, order)
        score_o = torch.where(keep_o, torch.gather(score, 1, order),
                              torch.zeros((), dtype=score.dtype,
                                          device=score.device))
        cls_o = torch.where(keep_o, torch.gather(cls_id, 1, order)
                            .to(score.dtype),
                            torch.full((), -1.0, dtype=score.dtype,
                                       device=score.device))
        k = a if nms_topk is None or nms_topk <= 0 else min(nms_topk, a)
        alive = greedy_nms(_iou(boxes_o[:, :k], boxes_o[:, :k]),
                           cls_o[:, :k] >= 0, nms_threshold,
                           None if force_suppress else cls_o[:, :k])
        cls_final = torch.cat([torch.where(alive, cls_o[:, :k],
                                           torch.full_like(cls_o[:, :k],
                                                           -1.0)),
                               torch.full_like(cls_o[:, k:], -1.0)], 1)
        return torch.cat([cls_final[..., None], score_o[..., None],
                          boxes_o], -1)
    return _apply(fn, cls_prob, loc_pred, anchor)
